"""Plain-XLA merge and compaction (ops.merge) vs numpy oracles."""

import numpy as np
import pytest

import jax.numpy as jnp

from orion_kmer_tpu.ops import merge as sp
from orion_kmer_tpu.ops.kmers import SENTINEL


def _rand_pairs(rng, n, hi_bits=30):
    hi = rng.integers(0, 1 << hi_bits, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("split", [(1 << 13, 1 << 13), (1 << 14, 1 << 14)])
def test_merge_sorted_pairs_matches_numpy(split):
    na, nb = split
    rng = np.random.default_rng(42)
    a_hi, a_lo = _rand_pairs(rng, na)
    b_hi, b_lo = _rand_pairs(rng, nb)
    av = np.sort((a_hi.astype(np.uint64) << np.uint64(32)) | a_lo)
    bv = np.sort((b_hi.astype(np.uint64) << np.uint64(32)) | b_lo)
    a_cnt = rng.integers(1, 100, size=na, dtype=np.int32)
    b_cnt = rng.integers(1, 100, size=nb, dtype=np.int32)
    shi, slo, scnt = sp.merge_sorted_pairs(
        jnp.asarray((av >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(av.astype(np.uint32)),
        jnp.asarray(a_cnt),
        jnp.asarray((bv >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(bv.astype(np.uint32)),
        jnp.asarray(b_cnt),
    )
    sv = np.asarray(shi).astype(np.uint64) << np.uint64(32) | np.asarray(slo)
    ev = np.sort(np.concatenate([av, bv]))
    np.testing.assert_array_equal(sv, ev)
    # counts travel with their keys: total and per-key sums preserved
    assert int(np.asarray(scnt).sum()) == int(a_cnt.sum()) + int(b_cnt.sum())
    # per-key check via grouped sums
    allv = np.concatenate([av, bv])
    allc = np.concatenate([a_cnt, b_cnt])
    order = np.argsort(allv, kind="stable")
    np.testing.assert_array_equal(allv[order], sv)
    # counts may be permuted within equal keys; compare grouped sums
    uniq, inv = np.unique(allv, return_inverse=True)
    esum = np.zeros(len(uniq), np.int64)
    np.add.at(esum, inv, allc)
    gsum = np.zeros(len(uniq), np.int64)
    np.add.at(gsum, np.searchsorted(uniq, sv), np.asarray(scnt))
    np.testing.assert_array_equal(gsum, esum)


def test_merge_unequal_split_power_of_two_total():
    rng = np.random.default_rng(7)
    na, nb = (3 << 12), (1 << 12)  # 12288 + 4096 = 16384
    av = np.sort(rng.integers(0, 1 << 63, size=na, dtype=np.uint64))
    bv = np.sort(rng.integers(0, 1 << 63, size=nb, dtype=np.uint64))
    shi, slo, scnt = sp.merge_sorted_pairs(
        jnp.asarray((av >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(av.astype(np.uint32)),
        jnp.ones(na, jnp.int32),
        jnp.asarray((bv >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(bv.astype(np.uint32)),
        jnp.ones(nb, jnp.int32),
    )
    sv = np.asarray(shi).astype(np.uint64) << np.uint64(32) | np.asarray(slo)
    np.testing.assert_array_equal(sv, np.sort(np.concatenate([av, bv])))
    assert int(np.asarray(scnt).sum()) == na + nb


@pytest.mark.parametrize("total", [1 << 14, 1 << 19, 1 << 20])
def test_merge_large_sizes(total):
    """Many merge-path blocks, up to 2^20 elements."""
    m = total // 2
    rng = np.random.default_rng(11)
    av = np.sort(rng.integers(0, 1 << 62, size=m, dtype=np.uint64))
    bv = np.sort(rng.integers(0, 1 << 62, size=m, dtype=np.uint64))
    shi, slo, scnt = sp.merge_sorted_pairs(
        jnp.asarray((av >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(av.astype(np.uint32)),
        jnp.ones(m, jnp.int32),
        jnp.asarray((bv >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(bv.astype(np.uint32)),
        jnp.ones(m, jnp.int32),
    )
    sv = np.asarray(shi).astype(np.uint64) << np.uint64(32) | np.asarray(slo)
    np.testing.assert_array_equal(sv, np.sort(np.concatenate([av, bv])))
    assert int(np.asarray(scnt).sum()) == total



def _sorted_run(rng, n, n_keys):
    """Ascending run with many duplicates and a SENTINEL tail."""
    if n_keys == 1:
        v = np.sort(rng.integers(0, n // 4 + 2, size=n).astype(np.uint64))
        v[-max(n // 8, 1):] = SENTINEL
    else:
        v = np.sort(rng.integers(0, n // 4 + 2, size=n).astype(np.uint64) * 0x9E3779B1)
        v[-max(n // 8, 1):] = (1 << 64) - 1
    return v


@pytest.mark.parametrize("split", ["equal", "unequal", "ragged"])
@pytest.mark.parametrize(
    "n_planes,n_keys", [(1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (5, 1), (5, 2)]
)
def test_merge_planes_matches_numpy(n_planes, n_keys, split):
    """Keys come out in numpy's sorted order and every payload plane
    stays with its own key (equal keys may permute their payloads)."""
    na, nb = {"equal": (4096, 4096), "unequal": (6144, 2048), "ragged": (3001, 1234)}[split]
    rng = np.random.default_rng(n_planes * 10 + n_keys)
    av, bv = _sorted_run(rng, na, n_keys), _sorted_run(rng, nb, n_keys)

    def planes(v, tag):
        keys = (
            [v.astype(np.uint32)]
            if n_keys == 1
            else [(v >> np.uint64(32)).astype(np.uint32), v.astype(np.uint32)]
        )
        pay = [np.arange(v.shape[0], dtype=np.uint32) * 8 + tag + p
               for p in range(n_planes - n_keys)]
        return keys + pay

    pa, pb = planes(av, 0), planes(bv, 4)
    out = [np.asarray(o) for o in sp.merge_sorted_planes(
        [jnp.asarray(x) for x in pa], [jnp.asarray(x) for x in pb], n_keys=n_keys
    )]
    allv = np.concatenate([av, bv])
    got = out[0].astype(np.uint64)
    if n_keys == 2:
        got = (got << np.uint64(32)) | out[1]
    np.testing.assert_array_equal(got, np.sort(allv))
    for p in range(n_planes - n_keys):
        want_pay = np.concatenate([pa[n_keys + p], pb[n_keys + p]])
        got_pay = out[n_keys + p]
        np.testing.assert_array_equal(np.sort(got_pay), np.sort(want_pay))
        key_of = dict(zip(want_pay.tolist(), allv.tolist()))
        assert [key_of[x] for x in got_pay.tolist()] == got.tolist()


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_compact_left_matches_numpy(density):
    rng = np.random.default_rng(int(density * 100))
    n = 1 << 13
    planes = [rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
              for _ in range(3)]
    keep = rng.random(n) < density
    out = sp.compact_left([jnp.asarray(p) for p in planes], jnp.asarray(keep))
    nk = int(keep.sum())
    for p, o in zip(planes, out):
        o = np.asarray(o)
        np.testing.assert_array_equal(o[:nk], p[keep])
        np.testing.assert_array_equal(o[nk:], 0)
