"""Lane-parallel canonical k-mer extraction.

Operates directly on the packed wire format (16 bases per u32 lane,
LSB-first within the lane) instead of expanding to one byte per base:
for each of the 16 intra-lane offsets, a window's 2k bits are assembled
from a (lane, lane+1, lane+2) triple with two shifts, and

  * the LSB-first window w IS the reverse complement up to complement:
    rc(kmer) = ~w & mask2k  (packing order reverses the base order)
  * the forward MSB-first kmer = 2-bit-group reversal of w

so canonicalization costs one reversal + compare per window, with all
arithmetic on u32 lanes -- about 2 VPU ops per base.  Outputs are in
(offset, lane) layout, i.e. position p = 16*lane + offset lives at
[p % 16, p // 16]; counting is order-independent so no transpose is
needed on the hot path.

XLA fuses the whole chain into the consumer of the outputs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import _reverse_2bit_groups_32, _shift_right_u64

U32 = jnp.uint32


def _u32(x: int):
    return np.uint32(x & 0xFFFFFFFF)


def lane_masks_from_invalid_words(invalid_words: jnp.ndarray):
    """u32 invalid bitmap (32 flags/word) -> per-lane 16-bit masks u32[W]."""
    lo = invalid_words & _u32(0xFFFF)
    hi = invalid_words >> _u32(16)
    return jnp.stack([lo, hi], axis=1).reshape(-1)


def extract_canonical_lane_math(A, B, C, MA, MB, MC, k: int, n_lanes_valid):
    """Core per-lane math of extract_canonical_lanes.

    A/B/C: lanes w, w+1, w+2 (u32, 16 bases each, LSB-first)
    MA/MB/MC: 16-bit invalid masks for the same lanes (u32)
    n_lanes_valid: number of lanes whose positions are in-range (windows
      starting in lane w need w+2 to exist; rolls wrap garbage which this
      bound invalidates).

    Returns (hi, lo, valid) each shaped (16,) + A.shape: offset-major.
    """
    mask2k_hi = _u32(((1 << (2 * k)) - 1) >> 32)
    mask2k_lo = _u32((1 << (2 * k)) - 1)
    maskk = _u32((1 << k) - 1)

    outs_hi, outs_lo, outs_valid = [], [], []
    for o in range(16):
        if o == 0:
            w_lo, w_hi = A, B
            m = MA | (MB << _u32(16))
        else:
            w_lo = (A >> _u32(2 * o)) | (B << _u32(32 - 2 * o))
            w_hi = (B >> _u32(2 * o)) | (C << _u32(32 - 2 * o))
            # invalid bits o..o+31 of the 48-bit (MA, MB, MC) triple
            m = (MA >> _u32(o)) | (MB << _u32(16 - o)) | (MC << _u32(32 - o))
        # (w_hi, w_lo) holds bases o..o+31 LSB-first; window = low 2k bits
        # rc (MSB-first) = complement of the LSB-first window
        rc_hi = (~w_hi) & mask2k_hi
        rc_lo = (~w_lo) & (mask2k_lo if k <= 16 else _u32(0xFFFFFFFF))
        if k <= 16:
            rc_hi = jnp.zeros_like(w_hi)
        # fwd (MSB-first) = 2-bit-group reversal of the window
        f_hi = _reverse_2bit_groups_32(w_lo)
        f_lo = _reverse_2bit_groups_32(w_hi)
        f_hi, f_lo = _shift_right_u64(f_hi, f_lo, 64 - 2 * k)
        take_rc = (rc_hi < f_hi) | ((rc_hi == f_hi) & (rc_lo < f_lo))
        c_hi = jnp.where(take_rc, rc_hi, f_hi)
        c_lo = jnp.where(take_rc, rc_lo, f_lo)
        window_ok = (m & maskk) == 0
        outs_hi.append(c_hi)
        outs_lo.append(c_lo)
        outs_valid.append(window_ok)

    hi = jnp.stack(outs_hi)
    lo = jnp.stack(outs_lo)
    valid = jnp.stack(outs_valid)
    # windows starting at lane >= n_lanes_valid read wrapped/garbage lanes
    lane_idx = jax.lax.broadcasted_iota(jnp.int32, valid.shape, valid.ndim - 1)
    valid = valid & (lane_idx < n_lanes_valid)
    return hi, lo, valid


@partial(jax.jit, static_argnames=("k",))
def extract_canonical_lanes(lanes, invalid_words, k: int, n_positions):
    """Lane-parallel extraction over the packed wire format.

    lanes: u32[W]; invalid_words: u32[W/2]; n_positions: real (unpadded)
    position count -- windows must fit inside it.

    Returns (hi, lo, valid) shaped (16, W): position p at [p%16, p//16].
    """
    W = lanes.shape[0]
    A = lanes
    B = jnp.roll(lanes, -1)
    C = jnp.roll(lanes, -2)
    M = lane_masks_from_invalid_words(invalid_words)
    MA = M
    MB = jnp.roll(M, -1)
    MC = jnp.roll(M, -2)
    # windows starting at position p need p + k - 1 < n_positions; handle
    # the per-position bound exactly via the offset dimension:
    hi, lo, valid = extract_canonical_lane_math(A, B, C, MA, MB, MC, k, W)
    off = jax.lax.broadcasted_iota(jnp.int32, (16, W), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (16, W), 1)
    pos = lane * 16 + off
    valid = valid & (pos <= n_positions - k)
    return hi, lo, valid
