"""Deterministic on-device k-mer counting: sort + run-length encode.

Replaces the reference's concurrent hash map (DashMap<u64, AtomicUsize>,
count.rs:23-38) and unique set (DashSet<u64>, build.rs:23-78).  Instead
of a lock-based table, the batch of canonical k-mers is sorted with
XLA's variadic sort (lexicographic on the (hi, lo) uint32 pair) and runs
are collapsed with segment sums -- fully deterministic and data-race-free
by construction.

Invalid windows carry the SENTINEL pair which sorts to the end and is
dropped by validity accounting.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import SENTINEL
from .merge import compact_left

U32 = jnp.uint32


def _mask_to_sentinel(hi, lo, valid):
    hi = jnp.where(valid, hi, SENTINEL)
    lo = jnp.where(valid, lo, SENTINEL)
    return hi, lo


def _rle_sorted(shi, slo, n_valid):
    """Run-length encode a sorted (hi, lo) stream whose valid prefix has
    length n_valid.  Returns compacted unique pairs, their counts and the
    number of uniques; the tail of the output arrays is SENTINEL/0.

    Run totals are next-head-index differences via a reverse cummin, and
    heads compact to the front (compact_left).
    """
    n = shi.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    in_prefix = idx < n_valid
    prev_hi = jnp.concatenate([jnp.full((1,), SENTINEL, U32), shi[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), SENTINEL, U32), slo[:-1]])
    is_new = (shi != prev_hi) | (slo != prev_lo)
    is_head = (is_new | (idx == 0)) & in_prefix

    head_pos = jnp.where(is_head, idx, n)
    next_head_incl = jax.lax.cummin(head_pos, reverse=True)
    next_head_after = jnp.concatenate(
        [next_head_incl[1:], jnp.full((1,), n, jnp.int32)]
    )
    run_end = jnp.minimum(next_head_after, n_valid)
    cnt = jnp.where(is_head, run_end - idx, 0)

    uhi, ulo, ucnt = compact_left([shi, slo, cnt], is_head)
    n_unique = is_head.astype(jnp.int32).sum()
    tail = idx >= n_unique
    uhi = jnp.where(tail, SENTINEL, uhi)
    ulo = jnp.where(tail, SENTINEL, ulo)
    ucnt = jnp.where(tail, 0, ucnt)
    return uhi, ulo, ucnt, n_unique


@jax.jit
def count_kmers(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray):
    """Count occurrences of each distinct (hi, lo) pair.

    Returns (unique_hi, unique_lo, counts, n_unique); uniques are sorted
    ascending by the 64-bit value (== lexicographic k-mer string order,
    the determinism anchor of count.rs:119).
    """
    hi, lo = _mask_to_sentinel(hi, lo, valid)
    n_valid = valid.astype(jnp.int32).sum()
    shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    return _rle_sorted(shi, slo, n_valid)


@jax.jit
def unique_kmers(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray):
    """Distinct (hi, lo) pairs, sorted ascending (build.rs:55 semantics)."""
    uhi, ulo, _counts, n_unique = count_kmers(hi, lo, valid)
    return uhi, ulo, n_unique


@partial(jax.jit, static_argnames=("k",))
def count_packed(lanes: jnp.ndarray, invalid_words: jnp.ndarray, k: int):
    """Exact count of one packed batch via the lane-parallel extractor
    (ops/kmers_lanes.py) -- no byte-per-base expansion, and counting is
    order-independent so the (offset, lane) layout flattens straight
    into the sort.  The hot pipeline uses sort_canonical_packed +
    rle_compact instead (RLE deferred to flush); this one-shot variant
    serves small inputs and tests."""
    from .kmers_lanes import extract_canonical_lanes

    n_positions = lanes.shape[0] * 16
    hi, lo, valid = extract_canonical_lanes(lanes, invalid_words, k, n_positions)
    return count_kmers(hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))


@partial(jax.jit, static_argnames=("k",))
def sort_canonical_packed(lanes: jnp.ndarray, invalid_words: jnp.ndarray, k: int):
    """Extract + globally sort the canonical k-mers of a packed batch.

    Returns (hi_sorted, lo_sorted, n_valid): a raw ascending weight-1
    stream with SENTINEL padding past n_valid.  No run-length encoding
    happens here: deduplication never shrinks the fixed-capacity device
    arrays, so duplicates ride along until one rle_compact at flush.
    """
    from .kmers_lanes import extract_canonical_lanes

    n_positions = lanes.shape[0] * 16
    hi, lo, valid = extract_canonical_lanes(lanes, invalid_words, k, n_positions)
    hi, lo = _mask_to_sentinel(hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))
    n_valid = valid.reshape(-1).astype(jnp.int32).sum()
    shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    return shi, slo, n_valid


def _rle_sorted_single(slo, n_valid):
    """Single-plane variant of _rle_sorted for the 2k <= 32 pipeline
    (the hi plane is identically zero for k <= 16, ops/kmers.py:155-157;
    carrying it through sort/merge/RLE wastes half the bandwidth)."""
    n = slo.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    in_prefix = idx < n_valid
    prev_lo = jnp.concatenate([jnp.full((1,), SENTINEL, U32), slo[:-1]])
    is_head = ((slo != prev_lo) | (idx == 0)) & in_prefix

    head_pos = jnp.where(is_head, idx, n)
    next_head_incl = jax.lax.cummin(head_pos, reverse=True)
    next_head_after = jnp.concatenate(
        [next_head_incl[1:], jnp.full((1,), n, jnp.int32)]
    )
    run_end = jnp.minimum(next_head_after, n_valid)
    cnt = jnp.where(is_head, run_end - idx, 0)

    ulo, ucnt = compact_left([slo, cnt], is_head)
    n_unique = is_head.astype(jnp.int32).sum()
    tail = idx >= n_unique
    ulo = jnp.where(tail, SENTINEL, ulo)
    ucnt = jnp.where(tail, 0, ucnt)
    return ulo, ucnt, n_unique


@partial(jax.jit, static_argnames=("k",))
def sort_canonical_packed_single(lanes: jnp.ndarray, invalid_words: jnp.ndarray, k: int):
    """2k <= 32 specialization of sort_canonical_packed: the canonical
    k-mer fits one u32 plane, so the sort is 1-key (XLA hands it to
    CUB's radix sort) and every later stage carries a single plane.
    Returns (lo_sorted, n_valid)."""
    from .kmers_lanes import extract_canonical_lanes

    assert 2 * k <= 32, k
    n_positions = lanes.shape[0] * 16
    _hi, lo, valid = extract_canonical_lanes(lanes, invalid_words, k, n_positions)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    lo = jnp.where(valid, lo, SENTINEL)
    n_valid = valid.astype(jnp.int32).sum()
    return jax.lax.sort(lo), n_valid


@jax.jit
def rle_compact_single(slo: jnp.ndarray, n_valid):
    """Single-plane run-length encode (see rle_compact)."""
    return _rle_sorted_single(slo, n_valid)


def narrow_u48(hi: jnp.ndarray, lo: jnp.ndarray, k: int):
    """Order-preserving re-split of a 32 < 2k <= 48 canonical value
    v = hi * 2^32 + lo (hi has only 2k-32 <= 16 live bits) into
    (t = v >> (2k-32), b = v & (2^(2k-32) - 1)): t fills exactly 32
    bits and b fits 16, so the sort's second key can be carried as a
    uint16 plane -- 6 bytes/element through the XLA sort instead of 8.
    Lexicographic (t, b) order == u64 order of v, and the SENTINEL pair
    stays safe: a real b always has its top 16 bits clear, so
    (0xFFFFFFFF, 0xFFFFFFFF) is never a data value (kmer.rs:37-57
    MSB-first packing puts the first bases in hi).
    """
    b_bits = 2 * k - 32
    assert 0 < b_bits <= 16, k
    t = (hi << np.uint32(32 - b_bits)) | (lo >> np.uint32(b_bits))
    b = lo & np.uint32((1 << b_bits) - 1)
    return t, b


def widen_u48_np(t: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """Host inverse of narrow_u48: (t, b) u32 planes -> u64 values."""
    b_bits = 2 * k - 32
    return (np.asarray(t, np.uint64) << np.uint64(b_bits)) | np.asarray(
        b, np.uint64
    )


@partial(jax.jit, static_argnames=("k",))
def sort_canonical_packed_u48(lanes: jnp.ndarray, invalid_words: jnp.ndarray, k: int):
    """32 < 2k <= 48 specialization of sort_canonical_packed (k=17..24,
    half the BASELINE.json north-star at k=21): keys are narrowed to a
    (t u32, b u16) pair (narrow_u48), so the batch sort moves 6
    bytes/element instead of 8.  Returns (t_sorted, b_sorted u32,
    n_valid) -- the b plane is widened back to u32 on the way out so the
    merge forest / RLE / combine pipeline is shared with the pair path
    verbatim ((t, b) is lexicographically ordered exactly like the
    (hi, lo) it replaces)."""
    from .kmers_lanes import extract_canonical_lanes

    assert 32 < 2 * k <= 48, k
    n_positions = lanes.shape[0] * 16
    hi, lo, valid = extract_canonical_lanes(lanes, invalid_words, k, n_positions)
    t, b = narrow_u48(hi.reshape(-1), lo.reshape(-1), k)
    valid = valid.reshape(-1)
    t = jnp.where(valid, t, SENTINEL)
    b16 = jnp.where(valid, b, 0xFFFF).astype(jnp.uint16)
    n_valid = valid.astype(jnp.int32).sum()
    st, sb = jax.lax.sort((t, b16), num_keys=2)
    return st, _widen_b16(st, sb), n_valid


def _widen_b16(st, sb):
    """u16 b plane -> u32, restoring full-SENTINEL tails.  A REAL value
    can never have t == SENTINEL for k <= 24: 16 leading T bases force
    (via the canonical = min(v, rc) compare) the 16 trailing bases to A,
    and those regions overlap for k < 32 -- so t alone identifies masked
    slots, and downstream merges/RLE see the exact u32 SENTINEL pair."""
    return jnp.where(st == SENTINEL, SENTINEL, sb.astype(U32))


@jax.jit
def rle_compact(shi: jnp.ndarray, slo: jnp.ndarray, n_valid):
    """Run-length encode a sorted stream (see _rle_sorted).

    Returns (uhi, ulo, counts, n_unique), sorted ascending with
    SENTINEL/0 padding past n_unique.
    """
    return _rle_sorted(shi, slo, n_valid)


@partial(jax.jit, static_argnames=("k",))
def count_packed_multi(lanes: jnp.ndarray, invalid_words: jnp.ndarray, k: int):
    """Single-dispatch exact count of a packed batch: sort + RLE.  Returns (uhi, ulo, counts,
    n_unique) with capacity = #positions."""
    shi, slo, n_valid = sort_canonical_packed(lanes, invalid_words, k)
    return rle_compact(shi, slo, n_valid)


def _combine_merged_unique(planes, n_valid, n_keys: int):
    """Shared tail of combine_sorted_unique*: given MERGED planes
    (keys... , cnt_lo, cnt_hi) where each key appears at most twice
    (both inputs were unique), sum the counts of equal keys with a
    32-bit carry and compact the survivors to the front."""
    keys = planes[:n_keys]
    cnt_lo, cnt_hi = planes[n_keys], planes[n_keys + 1]
    n = keys[0].shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    def eq(shift):
        parts = [
            k == jnp.concatenate([k[shift:], jnp.full((shift,), SENTINEL, U32)])
            for k in keys
        ]
        out = parts[0]
        for p in parts[1:]:
            out = out & p
        return out

    in_prefix = idx < n_valid
    eq_next = eq(1) & in_prefix & (idx + 1 < n_valid)
    next_lo = jnp.concatenate([cnt_lo[1:], jnp.zeros((1,), U32)])
    next_hi = jnp.concatenate([cnt_hi[1:], jnp.zeros((1,), U32)])
    add_lo = jnp.where(eq_next, next_lo, 0)
    add_hi = jnp.where(eq_next, next_hi, 0)
    new_lo = cnt_lo + add_lo
    carry = (new_lo < cnt_lo).astype(U32)
    new_hi = cnt_hi + add_hi + carry
    prev_eq = jnp.concatenate([jnp.zeros((1,), jnp.bool_), eq_next[:-1]])
    keep = in_prefix & ~prev_eq  # run heads only (runs have length <= 2)
    out = compact_left([*keys, new_lo, new_hi], keep)
    n_unique = keep.astype(jnp.int32).sum()
    tail = idx >= n_unique
    out_keys = [jnp.where(tail, SENTINEL, k) for k in out[:n_keys]]
    out_lo = jnp.where(tail, 0, out[n_keys])
    out_hi = jnp.where(tail, 0, out[n_keys + 1])
    return (*out_keys, out_lo, out_hi, n_unique)


@jax.jit
def combine_sorted_unique(a_hi, a_lo, a_clo, a_chi, a_n, b_hi, b_lo, b_clo, b_chi, b_n):
    """Merge two sorted-unique counted k-mer tables ((hi, lo) keys with
    64-bit counts as (cnt_lo, cnt_hi) u32 planes), summing counts of
    keys present in both.  Valid prefixes of length a_n/b_n; tails must
    be SENTINEL keys with zero counts (SENTINEL is never a canonical
    k-mer value: canonical = min(v, rc(v)) cannot be all-ones).

    The device-resident flush accumulator: epoch RLE outputs fold into
    one on-device table, so the host link carries the table ONCE at
    result() instead of every epoch, and the 1-core host does no merge
    work (classify.rs has no analog; count.rs:106-135 accumulates in the
    host HashMap).
    """
    from .merge import merge_sorted_planes

    merged = merge_sorted_planes(
        [a_hi, a_lo, a_clo, a_chi], [b_hi, b_lo, b_clo, b_chi]
    )
    return _combine_merged_unique(merged, a_n + b_n, 2)


@jax.jit
def combine_sorted_unique_single(a_lo, a_clo, a_chi, a_n, b_lo, b_clo, b_chi, b_n):
    """Single-plane (2k <= 32) variant of combine_sorted_unique."""
    from .merge import merge_sorted_planes

    merged = merge_sorted_planes(
        [a_lo, a_clo, a_chi], [b_lo, b_clo, b_chi], n_keys=1
    )
    return _combine_merged_unique(merged, a_n + b_n, 1)


@partial(jax.jit, static_argnames=("num_reads",))
def hits_per_read(member: jnp.ndarray, owner: jnp.ndarray, num_reads: int):
    """Sum window-level DB hits per read (query.rs:87-94 multiplicity
    semantics: every matching window counts, repeats included).

    ``owner`` must be sorted ascending (read regions are contiguous in
    position order -- true for every packed-batch layout here), so the
    per-read sums are prefix-sum differences at the owner boundaries:
    two num_reads-sized gathers."""
    prefix = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(member.astype(jnp.int32))]
    )
    reads = jnp.arange(num_reads, dtype=owner.dtype)
    starts = jnp.searchsorted(owner, reads, side="left")
    ends = jnp.searchsorted(owner, reads, side="right")
    return prefix[ends] - prefix[starts]
