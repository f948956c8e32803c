"""Lane-parallel extraction vs the host oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu.engine import pack_for_transfer
from orion_kmer_tpu.ops.kmers_lanes import extract_canonical_lanes


def _flat(hi, lo, valid, n):
    """(16, W) offset-major -> position-ordered u64 array of valid kmers."""
    hi, lo, valid = map(np.asarray, (hi, lo, valid))
    W = hi.shape[1]
    # position p = 16*lane + offset -> transpose to (lane, offset) and flatten
    hi_p = hi.T.reshape(-1)[:n]
    lo_p = lo.T.reshape(-1)[:n]
    v_p = valid.T.reshape(-1)[:n]
    return ((hi_p.astype(np.uint64) << np.uint64(32)) | lo_p.astype(np.uint64))[v_p]


@pytest.mark.parametrize("k", [1, 2, 5, 15, 16, 17, 21, 31, 32])
def test_lanes_extraction_matches_oracle(k):
    rng = np.random.default_rng(k)
    n = 4000
    seq = rng.choice(list(b"ACGTN"), size=n).astype(np.uint8).tobytes()
    codes = codec.seq_to_codes(seq)
    ref = codec.extract_kmers_np(codes, k)
    lanes, inv = pack_for_transfer(codes, 4096)
    hi, lo, valid = extract_canonical_lanes(jnp.asarray(lanes), jnp.asarray(inv), k, n)
    np.testing.assert_array_equal(_flat(hi, lo, valid, n), ref)


def test_exact_boundary_no_padding():
    # n_positions == 16*W: last windows must not read wrapped lanes
    k = 8
    n = 4096
    rng = np.random.default_rng(0)
    seq = rng.choice(list(b"ACGT"), size=n).astype(np.uint8).tobytes()
    codes = codec.seq_to_codes(seq)
    ref = codec.extract_kmers_np(codes, k)
    lanes, inv = pack_for_transfer(codes, n)
    hi, lo, valid = extract_canonical_lanes(jnp.asarray(lanes), jnp.asarray(inv), k, n)
    np.testing.assert_array_equal(_flat(hi, lo, valid, n), ref)
