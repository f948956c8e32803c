"""Merging sorted runs and compacting kept elements, in plain XLA.

Every multi-plane record here is a list of equal-length u32 planes whose
first ``n_keys`` planes form the key (2 = a u64 as a (hi, lo) pair, 1 = a
single u32); further planes are payload that travels with its key.

* **Merge** (merge_sorted_*): merge-path blocking (a lone key plane is
  instead re-sorted, which XLA hands to CUB).  The output is cut
  into blocks of MERGE_BLOCK elements; one binary search per block
  boundary finds how many elements of each run precede it (its co-rank),
  so each block is exactly a[i0:i1] ++ b[j0:j1].  One gather builds the
  blocks and one batched row sort orders each block in shared memory.
  Payload order within equal keys is unspecified.
* **Compaction** (compact_left): kept elements move to the front in
  order; one cumsum gives each its rank and one scatter per plane places
  it.  Slots past the kept count hold zeros the caller masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32

# Output elements per merge-path block (the width of each row sort).
MERGE_BLOCK = 256


def _le(a_keys, b_keys):
    """a <= b, lexicographic over the key planes (unsigned)."""
    if len(a_keys) == 1:
        return a_keys[0] <= b_keys[0]
    return (a_keys[0] < b_keys[0]) | ((a_keys[0] == b_keys[0]) & (a_keys[1] <= b_keys[1]))


def _co_rank(a_keys, b_keys, diag):
    """For each output position d in ``diag``, the number of elements of
    run a among the first d merged outputs (ties go to a first).

    Merge-path search: the count i lies in [max(0, d - nb), min(d, na)]
    and a[i] belongs before position d iff a[i] <= b[d - i - 1]."""
    na, nb = a_keys[0].shape[0], b_keys[0].shape[0]
    lo = jnp.maximum(diag - nb, 0)
    hi = jnp.minimum(diag, na)

    def step(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        ia = jnp.clip(mid, 0, na - 1)
        ib = jnp.clip(diag - mid - 1, 0, nb - 1)
        before = _le([k[ia] for k in a_keys], [k[ib] for k in b_keys])
        go = (lo < hi) & before
        return jnp.where(go, mid + 1, lo), jnp.where((lo < hi) & ~before, mid, hi)

    steps = max(na, 1).bit_length() + 1
    lo, _ = jax.lax.fori_loop(0, steps, step, (lo, hi))
    return lo


def merge_sorted_planes(a_planes, b_planes, n_keys: int = 2):
    """Merge two ascending-sorted plane tuples (any lengths, any plane
    dtypes of at most 32 bits).  Payload order within equal keys is
    unspecified."""
    na, nb = a_planes[0].shape[0], b_planes[0].shape[0]
    if na == 0 or nb == 0:
        return [jnp.concatenate([a, b]) for a, b in zip(a_planes, b_planes)]
    if len(a_planes) == 1:
        # one key plane, no payload: XLA hands this sort to CUB's radix
        # sort, which beats the blocked merge
        return [jax.lax.sort(jnp.concatenate([a_planes[0], b_planes[0]]))]
    n = na + nb
    T = min(MERGE_BLOCK, 1 << (n - 1).bit_length())
    nblk = -(-n // T)
    diag = jnp.minimum(jnp.arange(nblk + 1, dtype=jnp.int32) * T, n)
    ia = _co_rank(a_planes[:n_keys], b_planes[:n_keys], diag)
    ib = diag - ia
    take_a = (ia[1:] - ia[:-1])[:, None]  # a-elements in each block
    p = jnp.arange(T, dtype=jnp.int32)[None, :]
    from_a = p < take_a
    src_a = jnp.clip(ia[:-1, None] + p, 0, na - 1)
    src_b = jnp.clip(ib[:-1, None] + p - take_a, 0, nb - 1)
    rows = [
        jnp.where(from_a, pa[src_a], pb[src_b])
        for pa, pb in zip(a_planes, b_planes)
    ]
    ragged = nblk * T != n
    if ragged:
        # the last block is short: its unused slots sort after every real
        # element, whatever the keys (SENTINEL is a real k-mer at k=32)
        pad = (jnp.arange(nblk, dtype=jnp.int32)[:, None] * T + p) >= n
        rows = [pad.astype(U32)] + rows
    out = jax.lax.sort(tuple(rows), dimension=1, num_keys=n_keys + ragged)
    return [o.reshape(-1)[:n] for o in out[int(ragged):]]


@jax.jit
def merge_sorted_streams(a_hi, a_lo, b_hi, b_lo):
    """Merge two ascending-sorted (hi, lo) streams (duplicates allowed)."""
    return tuple(merge_sorted_planes([a_hi, a_lo], [b_hi, b_lo]))


@jax.jit
def merge_sorted_single(a, b):
    """Merge two ascending-sorted single-u32-plane streams (the 2k <= 32
    pipeline: one u32 holds the whole canonical k-mer)."""
    return merge_sorted_planes([a], [b], n_keys=1)[0]


@jax.jit
def merge_sorted_pairs(a_hi, a_lo, a_cnt, b_hi, b_lo, b_cnt):
    """Merge two ascending (hi, lo)-sorted runs carrying one int32
    payload plane each.  Returns the merged triple of length
    len(a) + len(b)."""
    return tuple(
        merge_sorted_planes([a_hi, a_lo, a_cnt], [b_hi, b_lo, b_cnt])
    )


def compact_left(planes, keep):
    """Move the kept elements of every plane to the front, in order.

    Slots past the kept count hold zeros; callers mask them."""
    n = keep.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    dst = jnp.where(keep, rank, n + idx)  # dropped: unique, out of range
    return [
        jnp.zeros_like(p).at[dst].set(p, mode="drop", unique_indices=True)
        for p in planes
    ]
