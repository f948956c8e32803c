"""FracMinHash / MinHash sketching on device.

New capability required by BASELINE.json config 3 (no reference
implementation exists in orion-kmer): scaled (FracMinHash) sketches over
the canonical k-mer hash stream, with Jaccard / containment estimators.

A k-mer is kept iff splitmix64(kmer) < 2^64 / scaled -- the standard
sourmash-style fraction-of-hash-space subsample.  Keeping is a pure
elementwise threshold on the (hi, lo) hash pair, fused by XLA into the
extraction chain; dedup + abundance reuse the sort+RLE counting kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .count import count_kmers
from .hash import splitmix64_np, splitmix64_pair
from .kmers import extract_canonical

U32 = jnp.uint32


def scaled_threshold(scaled: int) -> tuple[int, int]:
    """(hi, lo) words of floor(2^64 / scaled)."""
    if scaled < 1:
        raise ValueError(f"scaled must be >= 1, got {scaled}")
    thr = (1 << 64) // scaled
    return (thr >> 32) & 0xFFFFFFFF, thr & 0xFFFFFFFF


def _sparse_cap(n: int, scaled: int) -> int:
    """Output capacity for the sparse path: ~8x the expected survivor
    count (Chernoff makes overflow astronomically unlikely for hash-
    uniform data), floored and rounded to a power of two."""
    expected = max(1, n // scaled)
    cap = 1 << max(12, (8 * expected - 1).bit_length())
    return cap


def _keep_mask(hhi, hlo, valid, scaled: int):
    if scaled == 1:
        return valid  # threshold is the full 2^64 space: keep everything
    thr_hi, thr_lo = scaled_threshold(scaled)
    thr_hi = np.uint32(thr_hi)
    thr_lo = np.uint32(thr_lo)
    return valid & ((hhi < thr_hi) | ((hhi == thr_hi) & (hlo < thr_lo)))


def _sketch_from_hashes(hhi, hlo, valid, scaled: int, dense: bool = False):
    """Shared tail: threshold-filter hash pairs, dedupe + count.

    For scaled >> 1 only ~n/scaled hashes survive the threshold, so
    sorting the full stream wastes ~scaled x the work: the sparse path
    compacts survivors first, then sorts just the small survivor buffer.  Survivors can exceed the
    8x-headroom capacity when duplicate k-mers share a hash (a
    low-complexity repeat with multiplicity > 8n/scaled survives with
    probability ~1/scaled): the returned ``overflow`` flag is nonzero in
    that case and the result is truncated -- callers must retry via the
    exact dense path (``dense=True``), mirroring the a2a overflow-retry
    pattern.  Returns (uhi, ulo, counts, n_unique, overflow).
    """
    from .count import SENTINEL, _rle_sorted
    from .merge import compact_left

    keep = _keep_mask(hhi, hlo, valid, scaled)
    n = hhi.shape[0]
    cap = _sparse_cap(n, scaled)
    if dense or cap >= n:
        return count_kmers(hhi, hlo, keep) + (jnp.int32(0),)
    n_kept = keep.astype(jnp.int32).sum()
    overflow = (n_kept > cap).astype(jnp.int32)
    mhi = jnp.where(keep, hhi, SENTINEL)
    mlo = jnp.where(keep, hlo, SENTINEL)
    chi, clo = compact_left([mhi, mlo], keep)
    idx = jnp.arange(n, dtype=jnp.int32)
    # leftover tail slots may hold stale copies of kept values: sentinel
    # them before the sort so they cannot contaminate the prefix
    chi = jnp.where(idx < n_kept, chi, SENTINEL)[:cap]
    clo = jnp.where(idx < n_kept, clo, SENTINEL)[:cap]
    shi, slo = jax.lax.sort((chi, clo), num_keys=2)
    return _rle_sorted(shi, slo, jnp.minimum(n_kept, cap)) + (overflow,)


@partial(jax.jit, static_argnames=("k", "scaled", "dense"))
def sketch_batch(codes, invalid, k: int, scaled: int, dense: bool = False):
    """Extract canonical k-mers, hash, keep h < 2^64/scaled, dedupe+count.

    Returns (uhash_hi, uhash_lo, counts, n_unique, overflow): sorted
    unique KEPT hash values with their abundances.  A nonzero overflow
    means the sparse survivor buffer truncated (duplicate-heavy input);
    retry with dense=True for the exact result.
    """
    hi, lo, valid = extract_canonical(codes, invalid, k)
    hhi, hlo = splitmix64_pair(hi, lo)
    return _sketch_from_hashes(hhi, hlo, valid, scaled, dense=dense)


@partial(jax.jit, static_argnames=("k", "scaled", "dense"))
def sketch_packed(lanes, invalid_words, k: int, scaled: int, dense: bool = False):
    """sketch_batch over the packed wire format (3.2x less transfer,
    lane-parallel extraction)."""
    from .kmers_lanes import extract_canonical_lanes

    n_positions = lanes.shape[0] * 16
    hi, lo, valid = extract_canonical_lanes(lanes, invalid_words, k, n_positions)
    hhi, hlo = splitmix64_pair(hi.reshape(-1), lo.reshape(-1))
    return _sketch_from_hashes(hhi, hlo, valid.reshape(-1), scaled, dense=dense)


def sketch_compare(a: np.ndarray, b: np.ndarray) -> dict:
    """Jaccard/containment estimates between two sorted hash sets.

    FracMinHash estimators: since both sketches subsample the SAME hash
    space fraction, plain set Jaccard/containment over the sketch hashes
    estimates the genome-level values.
    """
    inter = np.intersect1d(a, b).shape[0]
    union = a.shape[0] + b.shape[0] - inter
    return {
        "intersection": int(inter),
        "union": int(union),
        "jaccard": (inter / union) if union else 0.0,
        "containment_a_in_b": (inter / a.shape[0]) if a.shape[0] else 0.0,
        "containment_b_in_a": (inter / b.shape[0]) if b.shape[0] else 0.0,
    }


def pairwise_intersections(sketch_hashes: list) -> np.ndarray:
    """All-pairs intersection sizes over P sorted-unique hash sets in
    ONE sort of the concatenation (replacing the O(P^2) per-pair
    np.intersect1d loop: a 10k-sketch cohort would do 50M host
    intersections; this is O(total log total + sum_h C(m_h, 2)) where
    m_h = #sketches containing hash h -- output-sized work).

    Each hash h present in m sketches contributes one count to each of
    its C(m, 2) sketch pairs: sort (hash, sketch_id) pairs, rank
    elements within equal-hash groups, and for stride d = 1..max_rank
    pair every element with the element d before it in its group --
    exactly the C(m, 2) enumeration, vectorized per stride.

    Returns int64 [P, P], symmetric with diagonal = sketch sizes.
    """
    P = len(sketch_hashes)
    mat = np.zeros((P, P), dtype=np.int64)
    if P == 0:
        return mat
    arrs = [np.asarray(h, dtype=np.uint64) for h in sketch_hashes]
    sizes = np.array([a.shape[0] for a in arrs], dtype=np.int64)
    np.fill_diagonal(mat, sizes)
    n = int(sizes.sum())
    if n == 0:
        return mat
    allh = np.concatenate(arrs)
    ids = np.repeat(np.arange(P, dtype=np.int32), sizes)
    order = np.argsort(allh, kind="stable")
    sh = allh[order]
    sid = ids[order]
    head = np.empty(n, dtype=bool)
    head[0] = True
    np.not_equal(sh[1:], sh[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    gidx = np.cumsum(head) - 1
    rank = np.arange(n, dtype=np.int64) - starts[gidx]
    max_rank = int(rank.max())
    # Elements with rank >= d form a suffix of a rank-stable-sorted index
    # array, so each stride slices a shrinking suffix (total work = the
    # number of pairs emitted) instead of rescanning all n elements per
    # d -- one near-universal hash among P otherwise-unique sketches
    # would otherwise cost O(max_rank * n) full scans.
    by_rank = np.argsort(rank, kind="stable")
    sorted_rank = rank[by_rank]
    for d in range(1, max_rank + 1):
        i = by_rank[np.searchsorted(sorted_rank, d, side="left") :]
        a = sid[i - d]
        b = sid[i]
        np.add.at(mat, (np.minimum(a, b), np.maximum(a, b)), 1)
    # mirror the upper triangle (diagonal already holds sizes)
    low = np.tril_indices(P, -1)
    mat[low] = mat.T[low]
    return mat


def sketch_np(vals: np.ndarray, scaled: int) -> np.ndarray:
    """Host oracle: FracMinHash of uint64 canonical k-mers."""
    h = splitmix64_np(np.unique(vals))
    thr = np.uint64((1 << 64) // scaled)
    return np.unique(h[h < thr])
