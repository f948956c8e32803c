"""Device kernels (ops/) validated bit-exactly against the host codec oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu.ops import count as ops_count
from orion_kmer_tpu.ops import kmers as ops_kmers
from orion_kmer_tpu.ops import setops as ops_setops


def _random_codes(rng, n, alphabet=b"ACGTNacgt"):
    seq = rng.choice(list(alphabet), size=n).astype(np.uint8).tobytes()
    codes = codec.seq_to_codes(seq, normalize=True)
    return codes, codes == codec.INVALID_CODE


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 15, 16, 17, 21, 27, 31, 32])
def test_extract_canonical_matches_oracle(k):
    rng = np.random.default_rng(k)
    codes, invalid = _random_codes(rng, 500)
    ref = codec.extract_kmers_np(codes, k, canonical=True)
    hi, lo, valid = ops_kmers.extract_canonical(jnp.asarray(codes), jnp.asarray(invalid), k)
    hi, lo, valid = np.asarray(hi), np.asarray(lo), np.asarray(valid)
    got = ops_kmers.join_u64(hi[valid], lo[valid])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 16, 17, 32])
def test_extract_noncanonical_matches_oracle(k):
    rng = np.random.default_rng(100 + k)
    codes, invalid = _random_codes(rng, 300)
    ref = codec.extract_kmers_np(codes, k, canonical=False)
    hi, lo, valid = ops_kmers.extract_canonical(
        jnp.asarray(codes), jnp.asarray(invalid), k, canonical=False
    )
    got = ops_kmers.join_u64(np.asarray(hi)[np.asarray(valid)], np.asarray(lo)[np.asarray(valid)])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [2, 16, 31])
def test_rc_pair_matches_oracle(k):
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 1 << min(2 * k, 63), size=200, dtype=np.uint64)
    hi, lo = ops_kmers.split_u64(vals)
    rhi, rlo = ops_kmers.reverse_complement_pair(jnp.asarray(hi), jnp.asarray(lo), k)
    got = ops_kmers.join_u64(np.asarray(rhi), np.asarray(rlo))
    np.testing.assert_array_equal(got, codec.reverse_complement_u64(vals, k))


def test_short_sequence_yields_nothing():
    codes = codec.seq_to_codes(b"ACG")
    hi, lo, valid = ops_kmers.extract_canonical(
        jnp.asarray(codes), jnp.asarray(codes == codec.INVALID_CODE), 5
    )
    assert not np.asarray(valid).any()


@pytest.mark.parametrize("k", [3, 21])
def test_count_kmers_matches_numpy(k):
    rng = np.random.default_rng(k)
    codes, invalid = _random_codes(rng, 2000, alphabet=b"ACGTN")
    ref_vals = codec.extract_kmers_np(codes, k)
    exp_vals, exp_counts = np.unique(ref_vals, return_counts=True)
    hi, lo, valid = ops_kmers.extract_canonical(jnp.asarray(codes), jnp.asarray(invalid), k)
    uhi, ulo, cnt, nu = ops_count.count_kmers(hi, lo, valid)
    nu = int(nu)
    got_vals = ops_kmers.join_u64(np.asarray(uhi)[:nu], np.asarray(ulo)[:nu])
    np.testing.assert_array_equal(got_vals, exp_vals)
    np.testing.assert_array_equal(np.asarray(cnt)[:nu], exp_counts)


def test_count_all_invalid():
    codes = np.full(64, codec.INVALID_CODE, dtype=np.uint8)
    hi, lo, valid = ops_kmers.extract_canonical(
        jnp.asarray(codes), jnp.asarray(codes == codec.INVALID_CODE), 4
    )
    _, _, _, nu = ops_count.count_kmers(hi, lo, valid)
    assert int(nu) == 0


class TestMembership:
    def test_against_numpy_isin(self):
        rng = np.random.default_rng(3)
        db = np.unique(rng.integers(0, 2**64, size=300, dtype=np.uint64))
        q = np.concatenate(
            [db[::3], rng.integers(0, 2**64, size=200, dtype=np.uint64)]
        )
        rng.shuffle(q)
        dh, dl = ops_kmers.split_u64(db)
        qh, ql = ops_kmers.split_u64(q)
        got = np.asarray(
            ops_setops.membership(
                jnp.asarray(qh),
                jnp.asarray(ql),
                jnp.ones(len(q), bool),
                jnp.asarray(dh),
                jnp.asarray(dl),
                jnp.ones(len(db), bool),
            )
        )
        np.testing.assert_array_equal(got, np.isin(q, db))

    def test_invalid_queries_never_match(self):
        db = np.array([5, 10], dtype=np.uint64)
        q = np.array([5, 10, 7], dtype=np.uint64)
        dh, dl = ops_kmers.split_u64(db)
        qh, ql = ops_kmers.split_u64(q)
        got = np.asarray(
            ops_setops.membership(
                jnp.asarray(qh),
                jnp.asarray(ql),
                jnp.asarray(np.array([True, False, True])),
                jnp.asarray(dh),
                jnp.asarray(dl),
                jnp.ones(2, bool),
            )
        )
        assert got.tolist() == [True, False, False]

    def test_db_padding_not_member(self):
        # sentinel-padded db slots must not match sentinel-masked queries
        db = np.array([5], dtype=np.uint64)
        dh = np.array([0, 0xFFFFFFFF], dtype=np.uint32)
        dl = np.array([5, 0xFFFFFFFF], dtype=np.uint32)
        qh = np.array([0xFFFFFFFF], dtype=np.uint32)
        ql = np.array([0xFFFFFFFF], dtype=np.uint32)
        got = np.asarray(
            ops_setops.membership(
                jnp.asarray(qh),
                jnp.asarray(ql),
                jnp.zeros(1, bool),
                jnp.asarray(dh),
                jnp.asarray(dl),
                jnp.asarray(np.array([True, False])),
            )
        )
        assert not got[0]


def test_intersection_size():
    rng = np.random.default_rng(9)
    a = np.unique(rng.integers(0, 1000, size=400, dtype=np.uint64))
    b = np.unique(rng.integers(500, 1500, size=400, dtype=np.uint64))
    ah, al = ops_kmers.split_u64(a)
    bh, bl = ops_kmers.split_u64(b)
    got = int(
        ops_setops.intersection_size(
            jnp.asarray(ah),
            jnp.asarray(al),
            jnp.ones(len(a), bool),
            jnp.asarray(bh),
            jnp.asarray(bl),
            jnp.ones(len(b), bool),
        )
    )
    assert got == len(np.intersect1d(a, b))


def test_hits_per_read():
    member = jnp.asarray(np.array([1, 1, 0, 1, 1, 0], dtype=bool))
    owner = jnp.asarray(np.array([0, 0, 0, 1, 2, 2], dtype=np.int32))
    hits = np.asarray(ops_count.hits_per_read(member, owner, 4))
    assert hits[:3].tolist() == [2, 1, 1]


def test_count_packed_multi_matches_count_packed(monkeypatch):
    """The single-dispatch sort+RLE counter must agree exactly with the
    plain per-batch counter (and hence with the numpy oracle)."""
    from orion_kmer_tpu.engine import pack_for_transfer

    rng = np.random.default_rng(5)
    n = 1 << 16
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    codes[rng.random(n) < 0.01] = 255
    lanes, inv = pack_for_transfer(codes, n)
    k = 13
    ehi, elo, ecnt, enu = ops_count.count_packed(
        jnp.asarray(lanes), jnp.asarray(inv), k
    )
    mhi, mlo, mcnt, mnu = ops_count.count_packed_multi(
        jnp.asarray(lanes), jnp.asarray(inv), k
    )
    enu, mnu = int(enu), int(mnu)
    assert mnu == enu
    np.testing.assert_array_equal(np.asarray(mhi[:mnu]), np.asarray(ehi[:enu]))
    np.testing.assert_array_equal(np.asarray(mlo[:mnu]), np.asarray(elo[:enu]))
    np.testing.assert_array_equal(np.asarray(mcnt[:mnu]), np.asarray(ecnt[:enu]))


def test_invalid_query_never_matches_T32_db_entry():
    """Regression: an invalid window is sentinel-masked to T^32's
    encoding; it must not match a genuine T^32 db entry (k=32)."""
    ff = np.uint32(0xFFFFFFFF)
    m = ops_setops.membership(
        jnp.asarray([ff, ff]),
        jnp.asarray([ff, ff]),
        jnp.asarray([False, True]),  # one invalid, one REAL T^32 window
        jnp.asarray([ff]),
        jnp.asarray([ff]),
        jnp.asarray([True]),
    )
    np.testing.assert_array_equal(np.asarray(m), [False, True])


def test_membership_sorted_matches_membership():
    rng = np.random.default_rng(77)
    nq, nd = 3000, 1 << 12
    qv64 = np.sort(rng.integers(0, 1 << 20, nq).astype(np.uint64))
    qv64 = np.unique(qv64)
    nq = len(qv64)
    dv64 = np.unique(rng.integers(0, 1 << 20, nd).astype(np.uint64))
    qs, ds = 1 << 12, 1 << 13
    qh = np.zeros(qs, np.uint32); ql = np.zeros(qs, np.uint32)
    qh[:nq] = (qv64 >> 32).astype(np.uint32); ql[:nq] = qv64.astype(np.uint32)
    qvalid = np.arange(qs) < nq
    dh = np.zeros(ds, np.uint32); dl = np.zeros(ds, np.uint32)
    dh[:len(dv64)] = (dv64 >> 32).astype(np.uint32); dl[:len(dv64)] = dv64.astype(np.uint32)
    dvalid = np.arange(ds) < len(dv64)
    a = np.asarray(ops_setops.membership(
        jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(qvalid),
        jnp.asarray(dh), jnp.asarray(dl), jnp.asarray(dvalid)))
    b = np.asarray(ops_setops.membership_sorted(
        jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(qvalid),
        jnp.asarray(dh), jnp.asarray(dl), jnp.asarray(dvalid)))
    exp = np.isin(qv64, dv64)
    np.testing.assert_array_equal(a[:nq], exp)
    np.testing.assert_array_equal(b[:nq], exp)
    assert not a[nq:].any() and not b[nq:].any()


def test_membership_pow2_total_merge_path():
    """nq + nd a power of two (no ragged merge block); results must
    match the numpy oracle."""
    rng = np.random.default_rng(88)
    qs = ds = 1 << 13  # total 2^14: merge path active
    nq, nd = 7000, 6000
    qv = rng.integers(0, 1 << 16, nq).astype(np.uint64)
    dv = np.unique(rng.integers(0, 1 << 16, nd).astype(np.uint64))
    nd = len(dv)
    qh = np.zeros(qs, np.uint32); ql = np.zeros(qs, np.uint32)
    qh[:nq] = (qv >> 32).astype(np.uint32); ql[:nq] = qv.astype(np.uint32)
    qvalid = np.arange(qs) < nq
    dh = np.zeros(ds, np.uint32); dl = np.zeros(ds, np.uint32)
    dh[:nd] = (dv >> 32).astype(np.uint32); dl[:nd] = dv.astype(np.uint32)
    dvalid = np.arange(ds) < nd
    got = np.asarray(ops_setops.membership(
        jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(qvalid),
        jnp.asarray(dh), jnp.asarray(dl), jnp.asarray(dvalid)))
    exp = np.isin(qv, dv)
    np.testing.assert_array_equal(got[:nq], exp)
    assert not got[nq:].any()


def test_merge_tree_odd_chunk_count(monkeypatch):
    """A batch whose size is not a power of two (3 x 2^10 positions)
    sorts every k-mer (an earlier chunked sort once dropped a third of
    them here)."""
    from orion_kmer_tpu.engine import pack_for_transfer

    rng = np.random.default_rng(7)
    n = 3 << 10
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    codes[rng.random(n) < 0.01] = 255
    lanes, inv = pack_for_transfer(codes, n)
    k = 11
    shi, slo, nv = ops_count.sort_canonical_packed(
        jnp.asarray(lanes), jnp.asarray(inv), k
    )
    nv = int(nv)
    ref = np.sort(codec.extract_kmers_np(codes, k, canonical=True))
    assert nv == ref.shape[0]
    got = ops_kmers.join_u64(np.asarray(shi)[:nv], np.asarray(slo)[:nv])
    np.testing.assert_array_equal(got, ref)


def test_check_db_sorted_debug_mode(monkeypatch):
    """ADVICE round 1: unsorted db planes must fail loudly under
    ORION_KMER_DEBUG=1 instead of returning silently wrong membership."""
    monkeypatch.setenv("ORION_KMER_DEBUG", "1")
    hi = np.array([2, 1], dtype=np.uint32)
    lo = np.array([0, 0], dtype=np.uint32)
    valid = np.array([True, True])
    with pytest.raises(ValueError, match="not sorted"):
        ops_setops.check_db_sorted(hi, lo, valid)
    # sorted db passes
    ops_setops.check_db_sorted(hi[::-1].copy(), lo, valid)
    # disabled by default
    monkeypatch.setenv("ORION_KMER_DEBUG", "0")
    ops_setops.check_db_sorted(hi, lo, valid)


class TestClassifyJoin:
    def _oracle(self, q, qv, d, dv):
        dset = set(d[dv].tolist())
        qset = set(q[qv].tolist())
        mq = np.array([bool(v) and int(x) in dset for x, v in zip(q, qv)])
        mdb = np.array([bool(v) and int(x) in qset for x, v in zip(d, dv)])
        return mq, mdb

    def _run(self, q, qv, d, dv):
        from orion_kmer_tpu.ops.kmers import split_u64

        qh, ql = split_u64(q)
        dh, dl = split_u64(d)
        bits_q, bits_db = ops_setops.classify_join(
            jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(qv),
            jnp.asarray(dh), jnp.asarray(dl), jnp.asarray(dv),
        )
        mq = np.unpackbits(np.asarray(bits_q).view(np.uint8), bitorder="little")
        mdb = np.unpackbits(np.asarray(bits_db).view(np.uint8), bitorder="little")
        return mq[: q.shape[0]].astype(bool), mdb[: d.shape[0]].astype(bool)

    def test_against_numpy_oracle(self):
        rng = np.random.default_rng(17)
        nd, nq = 256, 512
        d = np.unique(rng.integers(0, 1 << 40, size=nd, dtype=np.uint64))
        d = np.pad(d, (0, nd - d.shape[0]))  # back to nd, keep sorted tail
        d = np.sort(d)
        dv = np.ones(nd, dtype=bool)
        dv[rng.random(nd) < 0.1] = False
        # queries: unsorted concat of segments, half drawn from the db
        q = rng.integers(0, 1 << 40, size=nq, dtype=np.uint64)
        q[: nq // 2] = rng.choice(d, size=nq // 2)
        rng.shuffle(q)
        qv = rng.random(nq) < 0.9
        mq, mdb = self._run(q, qv, d, dv)
        # oracle treats invalid db rows as absent
        eq, edb = self._oracle(q, qv, np.where(dv, d, 0), dv)
        np.testing.assert_array_equal(mq, eq)
        np.testing.assert_array_equal(mdb, edb)

    def test_sentinel_t32_never_cross_matches(self):
        ff = np.uint64(0xFFFFFFFFFFFFFFFF)
        # db holds a REAL T^32; queries: one invalid (sentinel-masked),
        # one real T^32
        d = np.array([1, ff], dtype=np.uint64)
        dv = np.array([True, True])
        q = np.array([ff, ff, 2], dtype=np.uint64)
        qv = np.array([False, True, True])
        # pad to 32-multiples via the public helper contract: classify_join
        # requires multiples of 32; emulate engine bucketing
        qp = np.zeros(32, dtype=np.uint64); qp[:3] = q
        qvp = np.zeros(32, dtype=bool); qvp[:3] = qv
        dp = np.zeros(32, dtype=np.uint64); dp[:2] = d
        dvp = np.zeros(32, dtype=bool); dvp[:2] = dv
        mq, mdb = self._run(qp, qvp, dp, dvp)
        assert not mq[0]  # invalid query must not match real T^32
        assert mq[1]  # real T^32 query matches
        assert not mq[2]
        assert mdb[1] and not mdb[0]  # T^32 db row hit, '1' row not

    def test_empty_sides(self):
        q = np.zeros(32, dtype=np.uint64)
        qv = np.zeros(32, dtype=bool)
        d = np.zeros(32, dtype=np.uint64)
        dv = np.zeros(32, dtype=bool)
        mq, mdb = self._run(q, qv, d, dv)
        assert not mq.any() and not mdb.any()


def test_hits_per_read_random_sorted_owner():
    rng = np.random.default_rng(23)
    n, nr = 5000, 37
    owner = np.sort(rng.integers(0, nr, size=n)).astype(np.int32)
    member = rng.random(n) < 0.3
    hits = np.asarray(
        ops_count.hits_per_read(jnp.asarray(member), jnp.asarray(owner), 64)
    )
    exp = np.bincount(owner, weights=member.astype(np.int64), minlength=64)
    np.testing.assert_array_equal(hits, exp.astype(np.int64))


class TestSinglePlanePath:
    """2k <= 32 specialization (VERDICT round 1 #4): single u32 plane
    through sort/merge/RLE must agree bit-exactly with the pair path."""

    @pytest.mark.parametrize("k", [3, 8, 15, 16])
    def test_matches_general_path(self, k, monkeypatch):
        from orion_kmer_tpu.engine import pack_for_transfer

        rng = np.random.default_rng(40 + k)
        n = 1 << 14
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        codes[rng.random(n) < 0.01] = 255
        lanes, inv = pack_for_transfer(codes, n)
        slo, nv = ops_count.sort_canonical_packed_single(
            jnp.asarray(lanes), jnp.asarray(inv), k
        )
        ulo, ucnt, nu = ops_count.rle_compact_single(slo, nv)
        ghi, glo, gnv = ops_count.sort_canonical_packed(
            jnp.asarray(lanes), jnp.asarray(inv), k
        )
        euhi, eulo, eucnt, enu = ops_count.rle_compact(ghi, glo, gnv)
        nu, enu = int(nu), int(enu)
        assert nu == enu and int(nv) == int(gnv)
        np.testing.assert_array_equal(np.asarray(ulo)[:nu], np.asarray(eulo)[:enu])
        np.testing.assert_array_equal(np.asarray(ucnt)[:nu], np.asarray(eucnt)[:enu])
        # and against the host oracle
        ref_v, ref_c = np.unique(
            codec.extract_kmers_np(codes, k), return_counts=True
        )
        np.testing.assert_array_equal(
            np.asarray(ulo)[:nu].astype(np.uint64), ref_v
        )
        np.testing.assert_array_equal(np.asarray(ucnt)[:nu], ref_c)

    def test_t16_sentinel_collision(self):
        """Real T^16 k-mers encode to 0xFFFFFFFF == the SENTINEL pad;
        the valid-prefix accounting must keep their counts exact."""
        codes = np.concatenate(
            [
                np.full(20, 3, dtype=np.uint8),  # T^20: 5 T^16 windows
                np.array([255], dtype=np.uint8),
                np.array([0, 1, 2, 3] * 8, dtype=np.uint8),
            ]
        )
        n = 64
        from orion_kmer_tpu.engine import pack_for_transfer

        codes = np.pad(codes, (0, n - codes.shape[0]), constant_values=255)
        lanes, inv = pack_for_transfer(codes, n)
        k = 16
        slo, nv = ops_count.sort_canonical_packed_single(
            jnp.asarray(lanes), jnp.asarray(inv), k
        )
        ulo, ucnt, nu = ops_count.rle_compact_single(slo, nv)
        ref_v, ref_c = np.unique(
            codec.extract_kmers_np(codes, k), return_counts=True
        )
        nu = int(nu)
        np.testing.assert_array_equal(
            np.asarray(ulo)[:nu].astype(np.uint64), ref_v
        )
        np.testing.assert_array_equal(np.asarray(ucnt)[:nu], ref_c)
        # the canonical T^16 (= A^16... canonical of T^16 is A^16) plus
        # the ACGT-repeat k-mers must all be present with exact counts


class TestU48Path:
    """32 < 2k <= 48 specialization (VERDICT round 2 #1, k=21 is half
    the BASELINE.json north-star): keys narrowed to (t u32, b u16) for
    the batch sort must agree bit-exactly with the (hi, lo) pair path
    and the host oracle, after widening (t, b) back to u64."""

    @pytest.mark.parametrize("k", [17, 21, 24])
    def test_matches_general_path(self, k, monkeypatch):
        from orion_kmer_tpu.engine import pack_for_transfer

        rng = np.random.default_rng(50 + k)
        n = 1 << 14
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        codes[rng.random(n) < 0.01] = 255
        lanes, inv = pack_for_transfer(codes, n)
        st, sb, nv = ops_count.sort_canonical_packed_u48(
            jnp.asarray(lanes), jnp.asarray(inv), k
        )
        ut, ub, ucnt, nu = ops_count.rle_compact(st, sb, nv)
        ghi, glo, gnv = ops_count.sort_canonical_packed(
            jnp.asarray(lanes), jnp.asarray(inv), k
        )
        euhi, eulo, eucnt, enu = ops_count.rle_compact(ghi, glo, gnv)
        nu, enu = int(nu), int(enu)
        assert nu == enu and int(nv) == int(gnv)
        got_vals = ops_count.widen_u48_np(
            np.asarray(ut)[:nu], np.asarray(ub)[:nu], k
        )
        exp_vals = (np.asarray(euhi)[:enu].astype(np.uint64) << np.uint64(32)) | (
            np.asarray(eulo)[:enu].astype(np.uint64)
        )
        np.testing.assert_array_equal(got_vals, exp_vals)
        np.testing.assert_array_equal(
            np.asarray(ucnt)[:nu], np.asarray(eucnt)[:enu]
        )
        # and against the host oracle
        ref_v, ref_c = np.unique(
            codec.extract_kmers_np(codes, k), return_counts=True
        )
        np.testing.assert_array_equal(got_vals, ref_v)
        np.testing.assert_array_equal(np.asarray(ucnt)[:nu], ref_c)

    def test_low_complexity_narrow_ties(self):
        """Poly-A / near-poly-A runs stress equal-t, differing-b keys
        (the narrowed second plane is the only tiebreaker)."""
        k = 21
        from orion_kmer_tpu.engine import pack_for_transfer

        rng = np.random.default_rng(99)
        codes = np.zeros(2048, dtype=np.uint8)  # poly-A
        snp = rng.choice(2048, size=40, replace=False)
        codes[snp] = rng.integers(1, 4, size=40)  # sparse SNPs
        codes[rng.choice(2048, size=8, replace=False)] = 255
        lanes, inv = pack_for_transfer(codes, 2048)
        st, sb, nv = ops_count.sort_canonical_packed_u48(
            jnp.asarray(lanes), jnp.asarray(inv), k
        )
        ut, ub, ucnt, nu = ops_count.rle_compact(st, sb, nv)
        nu = int(nu)
        got_vals = ops_count.widen_u48_np(
            np.asarray(ut)[:nu], np.asarray(ub)[:nu], k
        )
        ref_v, ref_c = np.unique(
            codec.extract_kmers_np(codes, k), return_counts=True
        )
        np.testing.assert_array_equal(got_vals, ref_v)
        np.testing.assert_array_equal(np.asarray(ucnt)[:nu], ref_c)
