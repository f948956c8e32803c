"""Device k-mer extraction + canonicalization (JAX/XLA).

Design notes (this is NOT a port of the reference's per-window re-encode
loop, count.rs:28-37, which is O(len*k) scalar work):

  * JAX runs with 32-bit integers (x64 off), so a k-mer (k <= 32, 2 bits
    per base) is represented as a pair of uint32 words ``(hi, lo)``
    holding the MSB-first packed value ``hi * 2**32 + lo``.  All kernels
    operate on 32-bit lanes.

  * Packing is done with a logarithmic doubling scheme: arrays of packed
    2**m-base words are combined pairwise, so a full batch of N windows
    costs O(N log k) elementwise vector ops instead of O(N k) scalar ops.
    XLA fuses the whole chain into a handful of HBM passes.

  * Window invalidation (non-ACGT anywhere in the window => the window
    is skipped whole; kmer.rs:53, count.rs:36) is computed with a
    prefix-sum over the invalid mask.

  * Reverse complement uses 2-bit-group reversal bit tricks within each
    32-bit word (the 64-bit reversal of kmer.rs:79-94 decomposes into a
    word swap + per-word reversal + right shift), and canonical selection
    is a lexicographic (hi, lo) compare mirroring the u64 compare of
    kmer.rs:99-106.

Semantics are validated bit-exactly against ``orion_kmer_tpu.codec``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_MASK2 = np.uint32(0x33333333)
_MASK4 = np.uint32(0x0F0F0F0F)
_MASK8 = np.uint32(0x00FF00FF)
_MASK16 = np.uint32(0x0000FFFF)

# Sentinel pair that is strictly greater than any canonical k-mer.
# canonical(x) = min(x, rc(x)) can never be all-ones: for k=32 the only
# preimage of 2**64-1 is T^32 whose canonical is A^32 = 0; for k<32 the
# high bits are zero.  So (0xFFFFFFFF, 0xFFFFFFFF) is a safe +inf.
SENTINEL = np.uint32(0xFFFFFFFF)


def split_u64(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: uint64 array -> (hi, lo) uint32 arrays."""
    vals = np.asarray(vals, dtype=np.uint64)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host helper: (hi, lo) uint32 arrays -> uint64 array."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )


def _shift_left_array(arr: jnp.ndarray, s: int) -> jnp.ndarray:
    """arr[i + s] with wraparound garbage in the tail (masked by validity)."""
    if s == 0:
        return arr
    return jnp.roll(arr, -s)


def _reverse_2bit_groups_32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups within each uint32 lane."""
    x = ((x & _MASK2) << np.uint32(2)) | ((x >> np.uint32(2)) & _MASK2)
    x = ((x & _MASK4) << np.uint32(4)) | ((x >> np.uint32(4)) & _MASK4)
    x = ((x & _MASK8) << np.uint32(8)) | ((x >> np.uint32(8)) & _MASK8)
    x = ((x & _MASK16) << np.uint32(16)) | ((x >> np.uint32(16)) & _MASK16)
    return x


def _shift_right_u64(hi: jnp.ndarray, lo: jnp.ndarray, s: int):
    """Logical right shift of the (hi, lo) 64-bit pair by static s."""
    if s == 0:
        return hi, lo
    if s < 32:
        new_lo = (lo >> np.uint32(s)) | (hi << np.uint32(32 - s))
        new_hi = hi >> np.uint32(s)
        return new_hi, new_lo
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> np.uint32(s - 32)


def reverse_complement_pair(hi: jnp.ndarray, lo: jnp.ndarray, k: int):
    """RC of packed k-mers on (hi, lo) pairs (semantics of kmer.rs:79-94)."""
    # Complement = XOR every 2-bit group with 0b11 = bitwise NOT.
    chi = ~hi
    clo = ~lo
    # Reverse 2-bit groups across the 64-bit value: swap words + reverse
    # within each word.  Result occupies the TOP 2k bits; realign.
    rhi = _reverse_2bit_groups_32(clo)
    rlo = _reverse_2bit_groups_32(chi)
    return _shift_right_u64(rhi, rlo, 64 - 2 * k)


def canonical_pair(hi: jnp.ndarray, lo: jnp.ndarray, k: int):
    """Canonical = lexicographic min((hi,lo), rc(hi,lo)) (kmer.rs:99-106)."""
    rhi, rlo = reverse_complement_pair(hi, lo, k)
    take_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return jnp.where(take_rc, rhi, hi), jnp.where(take_rc, rlo, lo)


def _pack_pow2_tables(codes_u32: jnp.ndarray, max_pow: int) -> dict[int, jnp.ndarray]:
    """tables[m][i] = 2-bit MSB-first packing of codes[i : i + m], m = 1,2,4,8,16."""
    tables = {1: codes_u32}
    m = 1
    while m < max_pow:
        prev = tables[m]
        tables[2 * m] = (prev << np.uint32(2 * m)) | _shift_left_array(prev, m)
        m *= 2
    return tables


def _pack_arbitrary(tables: dict[int, jnp.ndarray], offset: int, length: int) -> jnp.ndarray:
    """pack[i] = 2-bit packing of codes[i + offset : i + offset + length] (length <= 16)."""
    assert 1 <= length <= 16
    acc = None
    pos = offset
    for b in (16, 8, 4, 2, 1):
        if length & b:
            part = _shift_left_array(tables[b], pos)
            acc = part if acc is None else (acc << np.uint32(2 * b)) | part
            pos += b
    return acc


@partial(jax.jit, static_argnames=("k", "canonical"))
def extract_canonical(codes: jnp.ndarray, invalid: jnp.ndarray, k: int, canonical: bool = True):
    """Extract (canonical) k-mers at every window start position.

    Args:
      codes:   uint8/uint32 [N] 2-bit base codes (value irrelevant where invalid)
      invalid: bool [N] True where the base is not ACGT
      k:       static k-mer length, 1..=32

    Returns:
      hi, lo: uint32 [N] packed k-mer per window start (garbage where ~valid)
      valid:  bool [N] window fits and contains no invalid base
    """
    n = codes.shape[0]
    c = codes.astype(U32) & np.uint32(3)
    max_pow = 16 if k > 1 else 1
    tables = _pack_pow2_tables(c, max_pow)

    if k <= 16:
        lo = _pack_arbitrary(tables, 0, k)
        hi = jnp.zeros_like(lo)
    else:
        # value = P(i, k-16) * 4^16 + P(i + k - 16, 16)
        hi = _pack_arbitrary(tables, 0, k - 16)
        lo = _pack_arbitrary(tables, k - 16, 16)

    # Window validity: no invalid base among codes[i : i+k] and i <= n-k.
    bad = jnp.cumsum(invalid.astype(jnp.int32))
    bad_before = jnp.concatenate([jnp.zeros(1, jnp.int32), bad[:-1]])
    bad_end = _shift_left_array(bad, k - 1)  # cumulative invalids through i+k-1
    window_bad = (bad_end - bad_before) > 0
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = (idx <= n - k) & ~window_bad

    if canonical:
        hi, lo = canonical_pair(hi, lo, k)
    return hi, lo, valid
