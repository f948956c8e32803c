"""Streaming multi-chip count accumulation: the sharded DeviceCountTable.

The single-chip pipeline (engine.DeviceCountTable) generalizes to an
n-device mesh with the same three stages, each distributed:

  1. per batch, chips extract canonical k-mers from their halo-split
     position blocks (data parallelism), route them to their hash-range
     owner with all_to_all (the table axis), and locally sort the
     received stream -- one shard_map dispatch per batch, including the
     batch's whole merge cascade;
  2. per-shard LSM merge forests accumulate the sorted streams with
     merges (each device merges only its own hash range -- no
     collectives after routing);
  3. at flush, each shard run-length compacts its range and the host
     merges the small per-shard unique tables.

Exactness: block halos produce every window exactly once, hash
ownership counts every distinct k-mer on exactly one chip, and the
all_to_all capacity is overflow-checked (psum) with exact retry.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..ops.kmers import SENTINEL, join_u64
from .sharded import _owner_of, _shard_blocks

U32 = jnp.uint32


def _pack_blocks(blk_codes: np.ndarray, blk_invalid: np.ndarray, block: int):
    """Pack S (row, stride) code blocks + invalid masks into wire-format
    rows of ``block`` positions: one native call for all rows, numpy
    fallback otherwise."""
    from ..ingest import native

    S, stride = blk_codes.shape
    if native.available():
        import ctypes

        lib = native._load()
        codes_c = np.ascontiguousarray(blk_codes, dtype=np.uint8)
        inv_c = np.ascontiguousarray(blk_invalid, dtype=np.uint8)
        lanes = np.empty((S, block // 16), dtype=np.uint32)
        inv_words = np.empty((S, block // 32), dtype=np.uint32)
        rc = lib.okt_pack_wire_multi(
            codes_c.ctypes.data_as(ctypes.c_void_p),
            inv_c.ctypes.data_as(ctypes.c_void_p),
            S,
            stride,
            block,
            lanes.ctypes.data_as(ctypes.c_void_p),
            inv_words.ctypes.data_as(ctypes.c_void_p),
        )
        assert rc == 0, f"okt_pack_wire_multi failed: {rc}"
        return lanes, inv_words
    from ..engine import pack_for_transfer

    lanes = np.empty((S, block // 16), dtype=np.uint32)
    inv_words = np.empty((S, block // 32), dtype=np.uint32)
    for s in range(S):
        row = np.where(blk_invalid[s], 255, blk_codes[s]).astype(np.uint8)
        lanes[s], inv_words[s] = pack_for_transfer(row, block)
    return lanes, inv_words


def _route_and_sort(lanes_blk, inv_words_blk, k: int, n_shards: int, cap: int):
    """Per-device: extract from the wire format, a2a-route by hash
    owner, sort received.

    Returns (shi, slo, n_valid, overflow): a raw ascending weight-1
    stream of this shard's owned k-mers (SENTINEL-padded) plus the
    psum'd overflow flag.
    """
    from ..ops.kmers_lanes import extract_canonical_lanes
    from ..ops.merge import compact_left, merge_sorted_pairs

    lanes_blk = lanes_blk.reshape(-1)
    inv_words_blk = inv_words_blk.reshape(-1)
    block = lanes_blk.shape[0] * 16
    hi, lo, valid = extract_canonical_lanes(lanes_blk, inv_words_blk, k, block)
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    b = hi.shape[0]
    hi = jnp.where(valid, hi, SENTINEL)
    lo = jnp.where(valid, lo, SENTINEL)
    owner = jnp.where(valid, _owner_of(hi, lo, n_shards), jnp.uint32(n_shards))
    sowner, shi, slo = jax.lax.sort((owner, hi, lo), num_keys=1)
    dests = jnp.arange(n_shards, dtype=jnp.uint32)
    starts = jnp.searchsorted(sowner, dests, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sowner, dests, side="right").astype(jnp.int32)
    counts = ends - starts
    overflow = (counts > cap).any().astype(jnp.int32)

    # expansion into per-destination slots (see
    # sharded.make_sharded_count_step_a2a for the derivation)
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
    _, mhi, mlo = merge_sorted_pairs(
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
        send_hi.reshape(n_shards, cap), "shard", split_axis=0, concat_axis=0
    ).reshape(-1)
    recv_lo = jax.lax.all_to_all(
        send_lo.reshape(n_shards, cap), "shard", split_axis=0, concat_axis=0
    ).reshape(-1)
    mine = ~((recv_hi == SENTINEL) & (recv_lo == SENTINEL))
    rhi = jnp.where(mine, recv_hi, SENTINEL)
    rlo = jnp.where(mine, recv_lo, SENTINEL)
    shi2, slo2 = jax.lax.sort((rhi, rlo), num_keys=2)
    n_valid = mine.astype(jnp.int32).sum()
    any_overflow = jax.lax.psum(overflow, "shard")
    return shi2, slo2, n_valid, any_overflow


def _route_and_sort_u48(
    lanes_blk, inv_words_blk, k: int, n_shards: int, cap: int
):
    """32 < 2k <= 48 variant of _route_and_sort: keys are narrowed to a
    (t u32, b u16) pair (ops.count.narrow_u48) BEFORE the all_to_all, so
    the collective ships 6 bytes/element instead of 8 -- a 25% interconnect
    traffic cut on the multi-chip bottleneck.  The b plane widens back
    to u32 after the receiver's sort, so every downstream stage (merge
    forest, RLE, fold) is the pair path verbatim on (t, b); only the
    host spill's u64 reconstruction differs (widen_u48_np).

    The SENTINEL t marker is safe for k <= 24 by the _widen_b16
    argument: a REAL canonical value can never have t == SENTINEL.
    """
    from ..ops.count import _widen_b16, narrow_u48
    from ..ops.kmers_lanes import extract_canonical_lanes
    from ..ops.merge import compact_left, merge_sorted_pairs

    lanes_blk = lanes_blk.reshape(-1)
    inv_words_blk = inv_words_blk.reshape(-1)
    block = lanes_blk.shape[0] * 16
    hi, lo, valid = extract_canonical_lanes(lanes_blk, inv_words_blk, k, block)
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    b = hi.shape[0]
    # ownership hashes the original (hi, lo) pair -- consistent with the
    # pair path, so shard assignment is identical across k classes
    owner = jnp.where(valid, _owner_of(hi, lo, n_shards), jnp.uint32(n_shards))
    t, bb = narrow_u48(hi, lo, k)
    t = jnp.where(valid, t, SENTINEL)
    bb = jnp.where(valid, bb, SENTINEL)
    sowner, st, sb = jax.lax.sort((owner, t, bb), num_keys=1)
    dests = jnp.arange(n_shards, dtype=jnp.uint32)
    starts = jnp.searchsorted(sowner, dests, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sowner, dests, side="right").astype(jnp.int32)
    counts = ends - starts
    overflow = (counts > cap).any().astype(jnp.int32)

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
    _, mt, mb = merge_sorted_pairs(
        dest_slot,
        st,
        sb.astype(jnp.int32),
        ukeys,
        jnp.full((M,), SENTINEL, U32),
        jnp.full((M,), SENTINEL, U32).astype(jnp.int32),
    )
    send_t = mt[:M]
    send_b16 = mb[:M].astype(jnp.uint16)  # <= 16 live bits: halve the wire

    recv_t = jax.lax.all_to_all(
        send_t.reshape(n_shards, cap), "shard", split_axis=0, concat_axis=0
    ).reshape(-1)
    recv_b16 = jax.lax.all_to_all(
        send_b16.reshape(n_shards, cap), "shard", split_axis=0, concat_axis=0
    ).reshape(-1)
    mine = recv_t != SENTINEL
    rt = jnp.where(mine, recv_t, SENTINEL)
    rb16 = jnp.where(mine, recv_b16, jnp.uint16(0xFFFF))
    st2, sb16 = jax.lax.sort((rt, rb16), num_keys=2)
    n_valid = mine.astype(jnp.int32).sum()
    any_overflow = jax.lax.psum(overflow, "shard")
    return st2, _widen_b16(st2, sb16), n_valid, any_overflow


def _route_and_sort_single(lanes_blk, inv_words_blk, k: int, n_shards: int, cap: int):
    """Single-plane (2k <= 32) variant of _route_and_sort: the canonical
    k-mer fits one u32, so the a2a ships HALF the interconnect traffic and the
    receiver sorts one plane.  SENTINEL doubles as the unfilled-slot
    marker, which is safe for CANONICAL k-mers: canonical = min(v, rc)
    can never be all-ones (that would need v = rc = T^k, but
    rc(T^k) = A^k), unlike raw window encodings.
    """
    from ..ops.kmers_lanes import extract_canonical_lanes
    from ..ops.merge import compact_left, merge_sorted_streams

    lanes_blk = lanes_blk.reshape(-1)
    inv_words_blk = inv_words_blk.reshape(-1)
    block = lanes_blk.shape[0] * 16
    _hi, lo, valid = extract_canonical_lanes(lanes_blk, inv_words_blk, k, block)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    b = lo.shape[0]
    lo = jnp.where(valid, lo, SENTINEL)
    owner = jnp.where(
        valid, _owner_of(jnp.zeros_like(lo), lo, n_shards), jnp.uint32(n_shards)
    )
    sowner, slo = jax.lax.sort((owner, lo), num_keys=1)
    dests = jnp.arange(n_shards, dtype=jnp.uint32)
    starts = jnp.searchsorted(sowner, dests, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sowner, dests, side="right").astype(jnp.int32)
    counts = ends - starts
    overflow = (counts > cap).any().astype(jnp.int32)

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
    # slot keys are a permutation of 0..M-1: a 2-key merge of
    # (dest_slot, payload) with (unfilled_slot, SENTINEL) places every
    # payload at its slot (merge_sorted_streams treats plane0 as hi key)
    mslot, mlo = merge_sorted_streams(
        dest_slot, slo, ukeys, jnp.full((M,), SENTINEL, U32)
    )
    send_lo = mlo[:M]

    recv_lo = jax.lax.all_to_all(
        send_lo.reshape(n_shards, cap), "shard", split_axis=0, concat_axis=0
    ).reshape(-1)
    mine = recv_lo != SENTINEL
    rlo = jnp.where(mine, recv_lo, SENTINEL)
    (slo2,) = jax.lax.sort((rlo,), num_keys=1)
    n_valid = mine.astype(jnp.int32).sum()
    any_overflow = jax.lax.psum(overflow, "shard")
    return slo2, n_valid, any_overflow


class ShardedCountTable:
    """Multi-chip streaming count accumulation over a (shard,) mesh.

    The distributed analog of engine.DeviceCountTable: call update() per
    host batch, result() once.  Per-shard state is a dict of
    capacity -> (hi [S, cap], lo [S, cap], n [S]) sharded runs.  Raw
    streams flush to the host accumulator every FLUSH_WINDOWS positions,
    bounding device memory and int32 counts exactly as the single-chip
    table does.
    """

    # Same knobs as the single-device table (None = derived from the
    # device's memory).  Each shard is one device, so the table bound is
    # per shard, not per mesh.
    FLUSH_WINDOWS: int | None = None
    DEVICE_TABLE_MAX: int | None = (
        int(os.environ.get("ORION_KMER_DEVICE_TABLE_MAX", 0)) or None
    )

    def _flush_windows(self) -> int:
        from .. import backend

        return self.FLUSH_WINDOWS or backend.flush_windows()

    def _device_table_max(self) -> int:
        from .. import backend

        return self.DEVICE_TABLE_MAX or backend.device_table_max()

    def __init__(self, k: int, mesh: Mesh | None = None, capacity_factor: float = 2.0):
        from .mesh import make_mesh
        from ..engine import CountAccumulator

        self.k = k
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.devices.size
        self.capacity_factor = capacity_factor
        # single-plane representation for 2k <= 32: half the a2a interconnect
        # traffic and half the sort/merge bandwidth (see
        # _route_and_sort_single and engine.DeviceCountTable)
        self._single = 2 * k <= 32
        # 32 < 2k <= 48 (k=21 is half the BASELINE north-star): route
        # with narrowed (t u32, b u16) keys so the all_to_all ships 25%
        # less interconnect traffic (_route_and_sort_u48); every later stage is
        # the pair path on (t, widened b)
        self._u48 = 32 < 2 * k <= 48
        # (a u16-b-plane forest variant was chip-validated in round 4
        # but measured at parity, not the projected +8-10%; deleted --
        # see engine.DeviceCountTable and BASELINE.md round-4 notes)
        self._tuple_len = 2 if self._single else 3
        self._runs: dict[int, tuple] = {}
        # Per-stage byte/dispatch accounting (VERDICT r3 item 6): pure
        # Python counters derived from static shapes -- zero device
        # fetches -- so the >=80% multi-chip scaling target
        # (BASELINE.json config 5) has an evidence path before real
        # chips exist: dryrun_multichip emits an interconnect-bytes-per-position
        # scaling report from these, and on hardware the same counters
        # attribute measured efficiency loss to routing vs merge vs
        # spill traffic.
        self.stats: dict[str, int] = {
            "positions": 0,  # input positions fed through update()
            "updates": 0,  # successful update() calls
            "route_dispatches": 0,  # route+sort shard_map launches (incl. retries)
            "route_retries": 0,  # overflow retries (capacity escalation)
            "a2a_bytes_sent": 0,  # bytes entering all_to_all, summed over shards
            "a2a_bytes_ici": 0,  # the (S-1)/S fraction that crosses the interconnect
            "recv_sort_elements": 0,  # post-a2a per-shard sort sizes, summed
            "merge_dispatches": 0,  # forest merge shard_map launches
            "merge_bytes": 0,  # key-plane bytes through forest merges
            "flush_dispatches": 0,  # flush RLE shard_map launches
            "rle_elements": 0,  # elements through flush RLE, summed over shards
            "fold_dispatches": 0,  # device-table combine/promote launches
            "fold_elements": 0,  # elements entering table folds, summed
            "spills": 0,  # device-table -> host-accumulator crossings
            "host_link_bytes": 0,  # actual bytes fetched over the host link
        }
        # device-resident accumulated table (VERDICT round 2 #2): epoch
        # RLE outputs fold into per-shard on-device 64-bit tables
        # (keys... , cnt_lo, cnt_hi as [S, cap] u32 planes + n [S]), so
        # the host link carries the table ONCE at result() instead of
        # every flush epoch -- the same design proven single-chip
        # (engine.DeviceCountTable._fold_into_table)
        self._table: tuple | None = None
        # host overflow tier: an incrementally-fed CountAccumulator
        # (amortized consolidation keeps host memory O(table), not
        # O(epochs x table) -- VERDICT round 2 weak #2)
        self._acc = CountAccumulator()
        self._chain_cache: dict = {}
        self._windows_since_flush = 0

    def _route_fn(self, cap: int, factor: float):
        """Jitted route+sort step for one per-destination capacity
        (per-level merges are separate programs, shared across fold
        depths; see engine.DeviceCountTable)."""
        key = ("route", cap, factor)
        fn = self._chain_cache.get(key)
        if fn is not None:
            return fn
        k, S = self.k, self.n_shards
        if self._single:

            def per_device(lanes_blk, inv_words_blk):
                slo, n_valid, ovf = _route_and_sort_single(
                    lanes_blk, inv_words_blk, k, S, cap
                )
                return slo[None], n_valid[None], ovf[None]

            out_specs = (P("shard", None), P("shard"), P("shard"))
        else:
            if self._u48:

                def per_device(lanes_blk, inv_words_blk):
                    shi, slo, n_valid, ovf = _route_and_sort_u48(
                        lanes_blk, inv_words_blk, k, S, cap
                    )
                    return shi[None], slo[None], n_valid[None], ovf[None]

            else:

                def per_device(lanes_blk, inv_words_blk):
                    shi, slo, n_valid, ovf = _route_and_sort(
                        lanes_blk, inv_words_blk, k, S, cap
                    )
                    return shi[None], slo[None], n_valid[None], ovf[None]

            out_specs = (
                P("shard", None),
                P("shard", None),
                P("shard"),
                P("shard"),
            )
        fn = jax.jit(
            jax.shard_map(
                per_device,
                mesh=self.mesh,
                in_specs=(P("shard", None), P("shard", None)),
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._chain_cache[key] = fn
        return fn

    def _merge_fn(self, cap: int):
        """Jitted per-shard merge of two equal-capacity run sets."""
        key = ("merge", cap)
        fn = self._chain_cache.get(key)
        if fn is not None:
            return fn
        from ..ops.merge import merge_sorted_single, merge_sorted_streams

        if self._single:

            def per_device(a_lo, a_n, b_lo, b_n):
                m = merge_sorted_single(a_lo.reshape(-1), b_lo.reshape(-1))
                return m[None], (a_n.reshape(()) + b_n.reshape(()))[None]

            in_specs = (P("shard", None), P("shard")) * 2
            out_specs = (P("shard", None), P("shard"))
        else:
            def per_device(a_hi, a_lo, a_n, b_hi, b_lo, b_n):
                mhi, mlo = merge_sorted_streams(
                    a_hi.reshape(-1),
                    a_lo.reshape(-1),
                    b_hi.reshape(-1),
                    b_lo.reshape(-1),
                )
                return mhi[None], mlo[None], (
                    a_n.reshape(()) + b_n.reshape(())
                )[None]

            in_specs = (P("shard", None), P("shard", None), P("shard")) * 2
            out_specs = (P("shard", None), P("shard", None), P("shard"))
        fn = jax.jit(
            jax.shard_map(
                per_device,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._chain_cache[key] = fn
        return fn

    def update(self, codes: np.ndarray, invalid: np.ndarray | None = None):
        if codes.shape[0] == 0:
            return
        if invalid is None:
            invalid = codes > 3
        S = self.n_shards
        blk_codes, blk_invalid, stride = _shard_blocks(codes, invalid, self.k, S)
        # ship the 0.3125 byte/base wire format: all S shard rows are
        # packed in ONE native call (okt_pack_wire_multi) -- the previous
        # per-shard Python loop (S pack_for_transfer calls + np.where
        # copies) made the 1-core host the bottleneck at large S
        block = -(-stride // 32) * 32  # wire packing needs 32-multiples
        lanes, inv_words = _pack_blocks(
            blk_codes.reshape(S, -1), blk_invalid.reshape(S, -1), block
        )
        sharding = NamedSharding(self.mesh, P("shard", None))
        d_codes = jax.device_put(lanes, sharding)
        d_invalid = jax.device_put(inv_words, sharding)

        st = self.stats
        factor = self.capacity_factor
        first_attempt = True
        while True:
            cap = int(np.ceil(factor * block / S))
            M = S * cap  # per-shard stream capacity for this batch
            # every attempt (retries included) ships a full a2a round:
            # each of S shards sends M elements, (S-1)/S of them over the interconnect
            bpe = self._route_bytes_per_elem()
            st["route_dispatches"] += 1
            st["route_retries"] += 0 if first_attempt else 1
            st["a2a_bytes_sent"] += S * M * bpe
            st["a2a_bytes_ici"] += M * bpe * (S - 1)
            st["recv_sort_elements"] += S * M
            first_attempt = False
            out = self._route_fn(cap, factor)(d_codes, d_invalid)
            ovf = out[-1]
            if int(np.asarray(ovf).max()) == 0:
                run = out[:-1]
                c = M
                while c in self._runs:
                    prev = self._runs.pop(c)
                    run = self._merge_fn(c)(*prev, *run)
                    st["merge_dispatches"] += 1
                    st["merge_bytes"] += S * 2 * c * self._forest_bytes_per_elem()
                    c *= 2
                self._runs[c] = run
                st["updates"] += 1
                st["positions"] += codes.shape[0]
                self._windows_since_flush += codes.shape[0]
                if self._windows_since_flush >= self._flush_windows():
                    self.flush()
                return
            if factor >= S:  # cap == block: overflow is impossible
                raise AssertionError("a2a overflow at full capacity")
            # exact retry with more headroom; factor == S is guaranteed
            # sufficient (every window of a block fits one destination)
            factor = min(factor * 4, S)

    def _route_bytes_per_elem(self) -> int:
        """Payload bytes per element through the routing all_to_all."""
        if self._single:
            return 4  # one u32 plane
        if self._u48:
            return 6  # (t u32, b u16) narrowed pair
        return 8  # (hi u32, lo u32)

    def _forest_bytes_per_elem(self) -> int:
        """Key-plane bytes per element through per-shard forest merges."""
        if self._single:
            return 4
        return 8

    def stats_report(self) -> dict:
        """Accounting snapshot with derived per-position traffic: the
        scaling-efficiency evidence (BASELINE.json config 5) a real
        multi-chip run will be judged by.  ici_bytes_per_position is
        the headline -- it is what rides the inter-chip links."""
        st = dict(self.stats)
        pos = max(st["positions"], 1)
        st["k"] = self.k
        st["n_shards"] = self.n_shards
        st["route"] = (
            "single" if self._single else ("u48" if self._u48 else "pair")
        )
        st["a2a_bytes_per_position"] = round(st["a2a_bytes_sent"] / pos, 3)
        st["ici_bytes_per_position"] = round(st["a2a_bytes_ici"] / pos, 3)
        st["host_link_bytes_per_position"] = round(st["host_link_bytes"] / pos, 4)
        return st

    def _flush_fn(self, cap: int):
        """Jitted per-shard RLE for one run capacity, cached so repeated
        flushes never re-jit (a fresh closure per call would miss
        jax.jit's cache every flush)."""
        key = ("flush", cap)
        fn = self._chain_cache.get(key)
        if fn is not None:
            return fn
        from ..ops.count import rle_compact, rle_compact_single

        if self._single:

            def per_shard(l, nn):
                ulo, ucnt, nu = rle_compact_single(l.reshape(-1), nn.reshape(()))
                return ulo[None], ucnt[None], nu[None]

            in_specs = (P("shard", None), P("shard"))
            out_specs = (P("shard", None), P("shard", None), P("shard"))
        else:
            def per_shard(h, l, nn):
                uhi, ulo, ucnt, nu = rle_compact(
                    h.reshape(-1), l.reshape(-1), nn.reshape(())
                )
                return uhi[None], ulo[None], ucnt[None], nu[None]

            in_specs = (P("shard", None), P("shard", None), P("shard"))
            out_specs = (
                P("shard", None),
                P("shard", None),
                P("shard", None),
                P("shard"),
            )
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._chain_cache[key] = fn
        return fn

    def _combine_fn(self, cap: int):
        """Jitted per-shard fold of one epoch's RLE output (int32
        counts) into the accumulated 64-bit table, both [S, cap]."""
        key = ("combine", cap)
        fn = self._chain_cache.get(key)
        if fn is not None:
            return fn
        from ..ops.count import combine_sorted_unique, combine_sorted_unique_single

        if self._single:

            def per_shard(t_lo, t_cl, t_ch, t_n, r_lo, r_cnt, r_n):
                r_cl = r_cnt.reshape(-1).astype(U32)
                out = combine_sorted_unique_single(
                    t_lo.reshape(-1),
                    t_cl.reshape(-1),
                    t_ch.reshape(-1),
                    t_n.reshape(()),
                    r_lo.reshape(-1),
                    r_cl,
                    jnp.zeros_like(r_cl),
                    r_n.reshape(()),
                )
                lo, cl, ch, n_new = out
                return lo[None], cl[None], ch[None], n_new[None]

            in_specs = (
                (P("shard", None),) * 3 + (P("shard"),)
                + (P("shard", None),) * 2 + (P("shard"),)
            )
            out_specs = (P("shard", None),) * 3 + (P("shard"),)
        else:

            def per_shard(t_hi, t_lo, t_cl, t_ch, t_n, r_hi, r_lo, r_cnt, r_n):
                r_cl = r_cnt.reshape(-1).astype(U32)
                out = combine_sorted_unique(
                    t_hi.reshape(-1),
                    t_lo.reshape(-1),
                    t_cl.reshape(-1),
                    t_ch.reshape(-1),
                    t_n.reshape(()),
                    r_hi.reshape(-1),
                    r_lo.reshape(-1),
                    r_cl,
                    jnp.zeros_like(r_cl),
                    r_n.reshape(()),
                )
                hi, lo, cl, ch, n_new = out
                return hi[None], lo[None], cl[None], ch[None], n_new[None]

            in_specs = (
                (P("shard", None),) * 4 + (P("shard"),)
                + (P("shard", None),) * 3 + (P("shard"),)
            )
            out_specs = (P("shard", None),) * 4 + (P("shard"),)
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._chain_cache[key] = fn
        return fn

    def _promote_fn(self, cap: int):
        """Jitted widen of one epoch's RLE output (int32 counts) to the
        64-bit table layout, for the first fold when no table exists."""
        key = ("promote", cap)
        fn = self._chain_cache.get(key)
        if fn is not None:
            return fn
        sharding = NamedSharding(self.mesh, P("shard", None))

        @jax.jit
        def promote(cnt):
            cl = cnt.astype(U32)
            return (
                jax.lax.with_sharding_constraint(cl, sharding),
                jax.lax.with_sharding_constraint(jnp.zeros_like(cl), sharding),
            )

        self._chain_cache[key] = promote
        return promote

    @staticmethod
    def _pad_cols(planes, cap: int, n_keys: int):
        """Pad [S, c] planes out to [S, cap] columns (SENTINEL keys,
        zero counts); sharding along axis 0 is preserved."""
        c = planes[0].shape[1]
        if c == cap:
            return list(planes)
        out = []
        for i, p in enumerate(planes):
            fill = SENTINEL if i < n_keys else 0
            padp = jnp.full((p.shape[0], cap - c), fill, p.dtype)
            out.append(jnp.concatenate([p, padp], axis=1))
        return out

    def _fold_into_table(self, key_planes, ucnt, n_u):
        """Merge one epoch's per-shard RLE output into the device
        table, spilling to the host accumulator at the capacity bound
        (mirrors engine.DeviceCountTable._fold_into_table)."""
        st = self.stats
        n_keys = len(key_planes)
        cap_run = key_planes[0].shape[1]
        if self._table is None:
            cl, ch = self._promote_fn(cap_run)(ucnt)
            self._table = (*key_planes, cl, ch, n_u)
            st["fold_dispatches"] += 1
            st["fold_elements"] += self.n_shards * cap_run
            return
        t = self._table
        cap = max(t[0].shape[1], cap_run)
        if 2 * cap > self._device_table_max():
            self._spill()
            cl, ch = self._promote_fn(cap_run)(ucnt)
            self._table = (*key_planes, cl, ch, n_u)
            st["fold_dispatches"] += 1
            st["fold_elements"] += self.n_shards * cap_run
            return
        t_planes = self._pad_cols(t[:-1], cap, n_keys)
        run = self._pad_cols([*key_planes, ucnt], cap, n_keys)
        out = self._combine_fn(cap)(*t_planes, t[-1], *run, n_u)
        self._table = tuple(out)
        st["fold_dispatches"] += 1
        st["fold_elements"] += self.n_shards * 2 * cap

    def _spill(self):
        """Fetch the device table into the host accumulator and reset.
        One link crossing per spill; the accumulator consolidates
        amortized so host memory stays O(table)."""
        if self._table is None:
            return
        *planes, n_dev = self._table
        n_host = np.asarray(n_dev)
        n_keys = 1 if self._single else 2
        planes_h = [np.asarray(p) for p in planes[:n_keys]]
        # narrow the count plane to the smallest dtype holding its max
        # (one scalar probe; engine._fetch_counts_narrow does the same
        # for the single-chip table) -- usually 1 B/key over the link
        from ..engine import _fetch_counts_narrow

        planes_h.append(
            _fetch_counts_narrow(planes[n_keys].reshape(-1), None).reshape(
                planes[n_keys].shape
            )
        )
        # high count plane: all-zero unless some k-mer passed 2^32
        # occurrences -- probe with one device scalar instead of always
        # crossing the link with 4 B/key (engine._spill does the same)
        chi_h = (
            np.asarray(planes[n_keys + 1])
            if bool(jnp.any(planes[n_keys + 1] != 0))
            else None
        )
        self.stats["spills"] += 1
        self.stats["host_link_bytes"] += (
            sum(int(p.nbytes) for p in planes_h)
            + (int(chi_h.nbytes) if chi_h is not None else 4)  # 4 = probe scalar
            + int(n_host.nbytes)
        )
        for s in range(self.n_shards):
            m = int(n_host[s])
            if not m:
                continue
            if self._single:
                vals = planes_h[0][s, :m].astype(np.uint64)
            elif self._u48:
                from ..ops.count import widen_u48_np

                # the table keys are the narrowed (t, b) pair
                vals = widen_u48_np(
                    planes_h[0][s, :m], planes_h[1][s, :m], self.k
                )
            else:
                vals = join_u64(planes_h[0][s, :m], planes_h[1][s, :m])
            cl = planes_h[n_keys][s, :m].astype(np.int64)
            if chi_h is not None:
                cl = cl + (chi_h[s, :m].astype(np.int64) << 32)
            self._acc.add(vals, cl)
        self._table = None

    def flush(self):
        from ..engine import _bucket

        for cap in sorted(self._runs):
            fn = self._flush_fn(cap)
            out = fn(*self._runs[cap])
            self.stats["flush_dispatches"] += 1
            self.stats["rle_elements"] += self.n_shards * cap
            *planes, nu = out
            # one small fetch per epoch: the per-shard unique counts,
            # to slice the full-capacity RLE buffers down to a tight
            # common bucket before folding (else table capacity tracks
            # the flush window, not the unique count)
            nu_host = np.asarray(nu)
            m = int(nu_host.max()) if nu_host.size else 0
            if m == 0:
                continue
            tight = _bucket(m)
            if tight < planes[0].shape[1]:
                planes = [p[:, :tight] for p in planes]
            self._fold_into_table(planes[:-1], planes[-1], nu)
        self._runs = {}
        self._windows_since_flush = 0

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """Final (vals uint64, counts int64), globally value-sorted.

        Within one flush epoch shard outputs are disjoint value sets
        (each k-mer is owned by one shard) and recurrences across
        epochs fold on-device; the host accumulator only sees one
        table per spill plus the final state."""
        self.flush()
        self._spill()
        return self._acc.result()
