"""64-bit hashing on (hi, lo) uint32 pairs.

JAX runs with 32-bit integers (x64 off), so 64-bit arithmetic (add,
mul, xor-shift) is done with 32-bit limb operations, written explicitly
so we control the op count.  Provides:

  * mix32_pair:       fast 32-bit finalizer for hash-range sharding
  * splitmix64_pair:  full-quality 64-bit finalizer (splitmix64), used
                      by FracMinHash sketching so sketch hashes are
                      uniform over [0, 2^64)

Host-side numpy uint64 twins (`splitmix64_np`) serve as oracles and as
the CPU fast path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32


def _u32(x: int):
    return np.uint32(x & 0xFFFFFFFF)


def _add64(ahi, alo, bhi, blo):
    lo = alo + blo
    carry = (lo < alo).astype(U32)
    hi = ahi + bhi + carry
    return hi, lo


def _mul32_full(a, b):
    """Full 64-bit product of two uint32 lanes -> (hi, lo) uint32."""
    a0 = a & _u32(0xFFFF)
    a1 = a >> _u32(16)
    b0 = b & _u32(0xFFFF)
    b1 = b >> _u32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> _u32(16)) + (p01 & _u32(0xFFFF)) + (p10 & _u32(0xFFFF))
    lo = (p00 & _u32(0xFFFF)) | ((mid & _u32(0xFFFF)) << _u32(16))
    hi = p11 + (p01 >> _u32(16)) + (p10 >> _u32(16)) + (mid >> _u32(16))
    return hi, lo


def _mul64(ahi, alo, bhi, blo):
    """Low 64 bits of a 64x64 product, as (hi, lo) uint32."""
    hi, lo = _mul32_full(alo, blo)
    hi = hi + alo * bhi + ahi * blo  # cross terms land in the high word
    return hi, lo


def _xorshift_right(hi, lo, s: int):
    """x ^= x >> s on a 64-bit (hi, lo) pair; 0 < s < 64 static."""
    if s < 32:
        shifted_hi = hi >> _u32(s)
        shifted_lo = (lo >> _u32(s)) | (hi << _u32(32 - s))
    elif s == 32:
        shifted_hi = jnp.zeros_like(hi)
        shifted_lo = hi
    else:
        shifted_hi = jnp.zeros_like(hi)
        shifted_lo = hi >> _u32(s - 32)
    return hi ^ shifted_hi, lo ^ shifted_lo


_SM_C1 = (0xBF58476D, 0x1CE4E5B9)  # 0xBF58476D1CE4E5B9
_SM_C2 = (0x94D049BB, 0x133111EB)  # 0x94D049BB133111EB
_SM_ADD = (0x9E3779B9, 0x7F4A7C15)  # 0x9E3779B97F4A7C15


def splitmix64_pair(hi, lo):
    """splitmix64 finalizer on (hi, lo) pairs -> hashed (hi, lo)."""
    hi, lo = _add64(hi, lo, _u32(_SM_ADD[0]), _u32(_SM_ADD[1]))
    hi, lo = _xorshift_right(hi, lo, 30)
    hi, lo = _mul64(hi, lo, _u32(_SM_C1[0]), _u32(_SM_C1[1]))
    hi, lo = _xorshift_right(hi, lo, 27)
    hi, lo = _mul64(hi, lo, _u32(_SM_C2[0]), _u32(_SM_C2[1]))
    hi, lo = _xorshift_right(hi, lo, 31)
    return hi, lo


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Host oracle: splitmix64 finalizer on numpy uint64."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def mix32_pair(hi, lo):
    """Fast 32-bit mix of a (hi, lo) pair for hash-range shard routing."""
    x = hi * _u32(0x85EBCA6B) ^ lo * _u32(0xC2B2AE35)
    x ^= x >> _u32(16)
    x = x * _u32(0x7FEB352D)
    x ^= x >> _u32(15)
    x = x * _u32(0x846CA68B)
    x ^= x >> _u32(16)
    return x


def mix32_np(vals: np.ndarray) -> np.ndarray:
    """Host oracle for mix32_pair on uint64 inputs."""
    vals = np.asarray(vals, dtype=np.uint64)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = vals.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = hi * np.uint32(0x85EBCA6B) ^ lo * np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
        x = x * np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x = x * np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x
