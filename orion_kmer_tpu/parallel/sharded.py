"""Hash-range-sharded multi-chip k-mer counting (shard_map + collectives).

Step layout (SURVEY.md section 2.3, "equivalent" column):

  1. the packed position stream is sharded over the ``shard`` mesh axis
     (data parallelism: each chip extracts canonical k-mers from its
     slice with the same kernel as the single-chip path)
  2. extracted k-mers are routed to their owner chip, where the owner of
     a k-mer is determined by a hash range split of the mix32 keyspace
     (tensor-parallel table partitioning)
  3. each owner sorts + run-length-encodes its range locally -- the
     per-chip outputs are globally disjoint, so no second reduction is
     needed; scalar stats merge with psum

Routing is capacity-bounded all_to_all by default (route_to_owners:
each chip sends only the owner's share over the interconnect, S times less traffic
than replication), with exactness preserved by an overflow flag +
doubled-capacity retry; the all_gather replication step remains as the
overflow-proof fallback.  The same route serves the cross-process
DCN-analog path (parallel.distributed.multihost_sharded_count).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..ops.count import count_kmers
from ..ops.hash import mix32_pair
from ..ops.kmers import extract_canonical, join_u64

U32 = jnp.uint32


def _owner_of(hi, lo, n_shards: int):
    """Map a (hi, lo) k-mer to its owner shard via the top hash bits."""
    h = mix32_pair(hi, lo)
    # floor(h/2^16 * S / 2^16): uniform for any S without 64-bit math
    return ((h >> U32(16)) * U32(n_shards)) >> U32(16)


def make_sharded_count_step(mesh: Mesh, k: int):
    """Build the jitted multi-chip count step for a (shard,) mesh.

    Returns fn(codes uint8 [S*B], invalid bool [S*B]) ->
      (uhi [S, S*B], ulo [S, S*B], counts [S, S*B], n_unique [S])
    where row s holds the sorted unique k-mers owned by shard s.
    """
    n_shards = mesh.devices.size

    def per_device(codes_blk, invalid_blk):
        # [1, B] local block -> flatten
        codes_blk = codes_blk.reshape(-1)
        invalid_blk = invalid_blk.reshape(-1)
        hi, lo, valid = extract_canonical(codes_blk, invalid_blk, k)
        # NOTE: windows at the tail of each block are invalid (the block
        # boundary cuts them); the host feeds blocks with a (k-1) halo so
        # every window is still produced exactly once.
        ghi = jax.lax.all_gather(hi, "shard", tiled=True)
        glo = jax.lax.all_gather(lo, "shard", tiled=True)
        gvalid = jax.lax.all_gather(valid, "shard", tiled=True)
        my = jax.lax.axis_index("shard")
        mine = gvalid & (_owner_of(ghi, glo, n_shards) == my)
        uhi, ulo, cnt, nu = count_kmers(ghi, glo, mine)
        return (
            uhi[None],
            ulo[None],
            cnt[None],
            nu[None],
        )

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("shard"), P("shard")),
        out_specs=(P("shard", None), P("shard", None), P("shard", None), P("shard")),
        check_vma=False,
    )
    return jax.jit(fn)


def route_to_owners(hi, lo, valid, n_shards: int, cap: int, axis_name: str = "shard"):
    """Owner-route extracted (hi, lo) k-mers over the mesh axis with a
    capacity-bounded all_to_all (the hash-range a2a route).

    Each chip sorts its k-mers by owner shard and sends only the owner's
    share over the interconnect -- S times less traffic than all_gather replication.
    Per (src, dst) capacity is ``cap``; the returned overflow flag is
    psum-reduced over shards so callers can retry with a larger capacity,
    preserving exactness.  Uniform mix32 hashing makes overflow at
    factor-2 capacity vanishingly rare for non-adversarial inputs.

    Returns (recv_hi [S*cap], recv_lo [S*cap], mine bool [S*cap],
    overflow int32 scalar).  Must be called inside shard_map over
    ``axis_name``.  Shared by the single-process sharded step and the
    cross-process multihost step (parallel.distributed).
    """
    from ..ops.kmers import SENTINEL
    from ..ops.merge import compact_left, merge_sorted_pairs

    b = hi.shape[0]
    hi = jnp.where(valid, hi, SENTINEL)
    lo = jnp.where(valid, lo, SENTINEL)
    owner = jnp.where(
        valid, _owner_of(hi, lo, n_shards), jnp.uint32(n_shards)
    )  # invalid entries sort past every real destination
    sowner, shi, slo = jax.lax.sort((owner, hi, lo), num_keys=1)
    dests = jnp.arange(n_shards, dtype=jnp.uint32)
    starts = jnp.searchsorted(sowner, dests, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sowner, dests, side="right").astype(jnp.int32)
    counts = ends - starts
    overflow = (counts > cap).any().astype(jnp.int32)

    # route each entry to slot owner*cap + rank_within_owner: entry
    # dest slots are strictly increasing (owner asc, rank asc), and the
    # unfilled slots are a sorted set, so the send buffer is a MERGE of
    # (dest_slot, hi, lo) with
    # (unfilled_slot, SENTINEL, SENTINEL) -- the slot keys form a
    # permutation of 0..M-1, making merged[t] the slot-t payload.
    M = n_shards * cap
    idx = jnp.arange(b, dtype=jnp.int32)
    rank = idx - starts[jnp.clip(sowner, 0, n_shards - 1).astype(jnp.int32)]
    routed = (sowner < n_shards) & (rank < cap)
    big = jnp.uint32(0x7FFFFFFF)
    dest_slot = jnp.where(routed, sowner * U32(cap) + rank.astype(U32), big)
    slot_t = jnp.arange(M, dtype=jnp.int32)
    unfilled = (slot_t % cap) >= jnp.repeat(counts, cap, total_repeat_length=M)
    (ukeys,) = compact_left([slot_t.astype(U32)], unfilled)
    n_unfilled = unfilled.astype(jnp.int32).sum()
    ukeys = jnp.where(slot_t < n_unfilled, ukeys, big)
    mkey, mhi, mlo = merge_sorted_pairs(
        dest_slot,
        shi,
        slo.astype(jnp.int32),
        ukeys,
        jnp.full((M,), SENTINEL, U32),
        jnp.full((M,), SENTINEL, U32).astype(jnp.int32),
    )
    send_hi = mhi[:M]
    send_lo = mlo[:M].astype(U32)

    recv_hi = jax.lax.all_to_all(
        send_hi.reshape(n_shards, cap), axis_name, split_axis=0, concat_axis=0
    ).reshape(-1)
    recv_lo = jax.lax.all_to_all(
        send_lo.reshape(n_shards, cap), axis_name, split_axis=0, concat_axis=0
    ).reshape(-1)

    mine = ~((recv_hi == SENTINEL) & (recv_lo == SENTINEL))
    any_overflow = jax.lax.psum(overflow, axis_name)
    return recv_hi, recv_lo, mine, any_overflow


def make_sharded_count_step_a2a(mesh: Mesh, k: int, capacity_factor: float = 2.0):
    """all_to_all variant of the sharded count step (route_to_owners).

    Returns fn(codes [S*B], invalid [S*B]) ->
      (uhi [S, S*C], ulo [S, S*C], counts [S, S*C], n_unique [S],
       overflow [S] int32)
    """
    n_shards = mesh.devices.size

    def per_device(codes_blk, invalid_blk):
        codes_blk = codes_blk.reshape(-1)
        invalid_blk = invalid_blk.reshape(-1)
        hi, lo, valid = extract_canonical(codes_blk, invalid_blk, k)
        cap = int(np.ceil(capacity_factor * hi.shape[0] / n_shards))
        recv_hi, recv_lo, mine, any_overflow = route_to_owners(
            hi, lo, valid, n_shards, cap
        )
        uhi, ulo, cnt, nu = count_kmers(recv_hi, recv_lo, mine)
        return uhi[None], ulo[None], cnt[None], nu[None], any_overflow[None]

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("shard"), P("shard")),
        out_specs=(
            P("shard", None),
            P("shard", None),
            P("shard", None),
            P("shard"),
            P("shard"),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def _shard_blocks(codes: np.ndarray, invalid: np.ndarray, k: int, n_shards: int):
    """Split a packed stream into S equal blocks with (k-1) halos.

    Blocks overlap by k-1 positions so that windows crossing block
    boundaries are produced by exactly one block (the left one produces
    them; the right block's copy starts at the same window but the left
    block's tail windows are cut by the block end -- overlap restores
    them exactly once).
    """
    n = codes.shape[0]
    halo = k - 1
    base = -(-n // n_shards)  # payload per shard
    block = base + halo
    out_codes = np.zeros((n_shards, block), dtype=np.uint8)
    out_invalid = np.ones((n_shards, block), dtype=bool)
    for s in range(n_shards):
        start = s * base
        stop = min(start + block, n)
        if start < n:
            span = stop - start
            out_codes[s, :span] = codes[start:stop]
            out_invalid[s, :span] = invalid[start:stop]
    return out_codes.reshape(-1), out_invalid.reshape(-1), block


def _assemble(uhi, ulo, cnt, nu, n_shards):
    vals_parts, cnt_parts = [], []
    for s in range(n_shards):
        m = int(nu[s])
        vals_parts.append(join_u64(uhi[s, :m], ulo[s, :m]))
        cnt_parts.append(cnt[s, :m].astype(np.int64))
    vals = np.concatenate(vals_parts)
    counts = np.concatenate(cnt_parts)
    order = np.argsort(vals)
    return vals[order], counts[order]


def sharded_count(
    codes: np.ndarray,
    invalid: np.ndarray,
    k: int,
    mesh: Mesh | None = None,
    use_all_to_all: bool = True,
    capacity_factor: float = 2.0,
):
    """Multi-chip canonical k-mer count of one packed stream.

    Exactness: block halos ensure each window is produced once; hash
    ownership ensures each distinct k-mer is counted by exactly one
    shard.  Prefers the all_to_all routing (S times less interconnect traffic);
    on capacity overflow retries with doubled capacity, then falls back
    to the replication path.  Returns (vals uint64, counts int64) sorted.
    """
    from .mesh import make_mesh

    if mesh is None:
        mesh = make_mesh()
    n_shards = mesh.devices.size
    blk_codes, blk_invalid, block = _shard_blocks(codes, invalid, k, n_shards)
    sharding = NamedSharding(mesh, P("shard"))
    d_codes = jax.device_put(blk_codes, sharding)
    d_invalid = jax.device_put(blk_invalid, sharding)

    if use_all_to_all and n_shards > 1:
        factor = capacity_factor
        for _attempt in range(3):
            step = make_sharded_count_step_a2a(mesh, k, factor)
            uhi, ulo, cnt, nu, ovf = map(np.asarray, step(d_codes, d_invalid))
            if int(ovf.max()) == 0:
                return _assemble(uhi, ulo, cnt, nu, n_shards)
            factor *= 2  # exact: retry with more headroom
    step = make_sharded_count_step(mesh, k)
    uhi, ulo, cnt, nu = map(np.asarray, step(d_codes, d_invalid))
    return _assemble(uhi, ulo, cnt, nu, n_shards)
