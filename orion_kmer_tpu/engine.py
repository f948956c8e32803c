"""Batched host<->device execution pipeline.

The host packs FASTA/FASTQ records into fixed-shape 2-bit code tensors
(records separated by k-1 invalid positions so no window spans two
records; long records are split with a (k-1)-base halo so every window is
produced exactly once -- the k-mer analog of blockwise context
parallelism, see SURVEY.md section 5).  The device extracts + sorts each
batch into a raw canonical k-mer stream, accumulates streams in an LSM
merge forest (single-chip DeviceCountTable here; the mesh-wide
ShardedCountTable in parallel/streaming.py), and run-length encodes once
per flush; the host merges flush epochs with one vectorized reduction.

Shapes are padded to power-of-two buckets so XLA compiles each kernel a
bounded number of times.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import codec
from .errors import ContextError
from .utils.jaxcache import enable_persistent_cache

enable_persistent_cache()
from .ingest.fastx import Record, parse_fastx_file
from .ops.count import count_kmers, hits_per_read
from .ops.kmers import extract_canonical, join_u64, split_u64
from .ops.setops import membership

# Positions per device batch, resolved lazily (0 = unresolved) because
# the right size depends on the platform (backend.default_batch);
# ORION_KMER_BATCH overrides it.
_DEFAULT_BATCH = int(os.environ.get("ORION_KMER_BATCH", 0))


def default_batch() -> int:
    """Positions per device batch."""
    global _DEFAULT_BATCH
    if not _DEFAULT_BATCH:
        from . import backend

        _DEFAULT_BATCH = backend.default_batch()
    return _DEFAULT_BATCH

_MIN_BUCKET = 4096
_READS_BUCKET = 4096


def _bucket(n: int, minimum: int = _MIN_BUCKET) -> int:
    return max(minimum, 1 << max(n - 1, 1).bit_length())


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pack_for_transfer(codes: np.ndarray, size: int):
    """Host-side wire packing: codes u8[n] (255 = invalid) padded to
    ``size`` (multiple of 32) -> (lanes u32[size/16], invalid u32[size/32]).

    Base j of lane w sits at bits 2j..2j+1 of lanes[w]; invalid flags are
    1 bit per base, little-endian within each u32 word.  Uses the native
    C packer when available (~5x the numpy path single-core; packing is
    on the host's critical path alongside parsing)."""
    assert size % 32 == 0
    from .ingest import native

    if native.available():
        return native.pack_wire(codes, size)
    codes_p = _pad(codes, size, codec.INVALID_CODE)
    invalid = codes_p > 3
    c = np.where(invalid, 0, codes_p).astype(np.uint32).reshape(-1, 16)
    lanes = np.zeros(size // 16, dtype=np.uint32)
    for j in range(16):
        lanes |= c[:, j] << np.uint32(2 * j)
    inv_words = np.packbits(invalid, bitorder="little").view(np.uint32)
    return lanes, inv_words


class PackedBatch(NamedTuple):
    codes: np.ndarray  # uint8 [n]
    invalid: np.ndarray  # bool [n]
    owner: np.ndarray | None  # int32 [n]: local record index per position
    first_rid: int  # global index of local record 0
    record_ids: list[bytes] | None  # ids of records present in this batch


def iter_packed_batches(
    records: Iterable[Record],
    k: int,
    normalize: bool = True,
    batch_positions: int = 0,
    with_owner: bool = False,
) -> Iterator[PackedBatch]:
    """Pack records into batches of 2-bit codes with separators/halos.

    A record longer than the remaining batch space is split with a
    (k-1)-position halo; it then appears in multiple batches under the
    same global record index (= first_rid + local owner), and callers
    must sum per-record statistics across batches.
    """
    batch_positions = batch_positions or default_batch()
    sep = k - 1
    sep_arr = np.full(sep, codec.INVALID_CODE, dtype=np.uint8)

    parts: list[np.ndarray] = []
    owners: list[np.ndarray] = []
    batch_ids: list[bytes] = []
    batch_first_rid = 0
    used = 0
    global_rid = -1

    def make_batch() -> PackedBatch:
        codes = np.concatenate(parts) if len(parts) > 1 else parts[0]
        owner = None
        if with_owner:
            owner = np.concatenate(owners) if len(owners) > 1 else owners[0]
        return PackedBatch(
            codes=codes,
            invalid=codes == codec.INVALID_CODE,
            owner=owner,
            first_rid=batch_first_rid,
            record_ids=list(batch_ids) if with_owner else None,
        )

    for rec in records:
        global_rid += 1
        if with_owner:
            batch_ids.append(rec.id)
        rcodes = codec.seq_to_codes(rec.seq, normalize=normalize)
        pos = 0
        while True:
            if used >= batch_positions:
                yield make_batch()
                parts, owners, used = [], [], 0
                batch_first_rid = global_rid
                batch_ids = [rec.id] if with_owner else []
            room = batch_positions - used
            take = min(len(rcodes) - pos, max(room, k))
            piece = rcodes[pos : pos + take]
            parts.append(piece)
            if with_owner:
                owners.append(
                    np.full(len(piece), global_rid - batch_first_rid, dtype=np.int32)
                )
            used += len(piece)
            if pos + take >= len(rcodes):
                break
            pos = pos + take - (k - 1)  # halo: boundary windows produced once
        # separator so no window spans into the next record
        parts.append(sep_arr)
        if with_owner:
            owners.append(np.full(sep, global_rid - batch_first_rid, dtype=np.int32))
        used += sep

    if parts:
        yield make_batch()


def _iter_batches_from_packed(
    codes: np.ndarray,
    rec_ends: np.ndarray,
    ids: list[bytes],
    k: int,
    batch_positions: int,
    with_owner: bool,
    rid_offset: int = 0,
) -> Iterator[PackedBatch]:
    """Batch a natively-packed code stream with (k-1) halos at splits.

    ``rid_offset`` shifts first_rid so record indices stay globally
    unique when the stream arrives as multiple chunks."""
    n = codes.shape[0]
    invalid = codes == codec.INVALID_CODE
    owner_full = None
    if with_owner:
        sep = k - 1
        ends_incl = rec_ends + sep  # each record region includes its separator
        lengths = np.diff(np.concatenate([[0], ends_incl]))
        owner_full = np.repeat(
            np.arange(len(ids), dtype=np.int32), lengths.astype(np.int64)
        )
    a = 0
    while True:
        b = min(a + batch_positions, n)
        sl_codes = codes[a:b]
        owner = None
        first_rid = 0
        rec_ids = None
        if with_owner:
            first_rid = int(owner_full[a]) if n else 0
            last_rid = int(owner_full[b - 1]) if n else -1
            owner = owner_full[a:b] - np.int32(first_rid)
            rec_ids = ids[first_rid : last_rid + 1]
            first_rid += rid_offset
        yield PackedBatch(
            codes=sl_codes,
            invalid=invalid[a:b],
            owner=owner,
            first_rid=first_rid,
            record_ids=rec_ids,
        )
        if b >= n:
            break
        a = b - (k - 1)  # halo: boundary windows produced exactly once


# Decompressed bytes pulled per streaming-ingest chunk.  Memory per open
# stream is O(chunk + largest record), never O(file): the reference
# streams through BufRead decoders with a per-record loop
# (utils.rs:125-152, count.rs:63-79) and a ~250 GB decompressed FASTQ
# must not be materialized.
CHUNK_BYTES = int(os.environ.get("ORION_KMER_CHUNK_BYTES", str(64 << 20)))


def stream_native_chunks(
    path, k: int, normalize: bool = True, chunk_bytes: int | None = None
) -> Iterator[tuple[np.ndarray, np.ndarray, list[bytes]]]:
    """Chunked-decompression -> incremental native parse: yields
    (codes, rec_ends, ids) tuples of WHOLE records; a record spanning a
    chunk boundary is carried over (so one yield can exceed chunk_bytes
    only by the unfinished record's length)."""
    from .ingest import native
    from .ingest.compress import open_input

    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES
    src = str(path)
    seen = False
    carry = b""
    with open_input(path) as f:
        while True:
            try:
                data = f.read(chunk_bytes)
            except OSError as e:
                raise ContextError(f"Failed to read input file: {src!r}", e) from e
            eof = not data
            buf = carry + data if carry else data
            if eof and not buf:
                if seen:
                    return
                raise native.NativeParseError(native.OKT_EMPTY, src)
            try:
                codes, rec_ends, ids, consumed = native.parse_fastx_chunk(
                    buf, k, normalize=normalize, eof=eof, source=src
                )
            except native.NativeParseError as e:
                if eof and seen and e.code == native.OKT_EMPTY:
                    return  # trailing whitespace after real records
                raise
            if ids:
                seen = True
                yield codes, rec_ends, ids
            if eof:
                return
            carry = buf[consumed:]


def _rebatch_codes(
    chunks, k: int, batch_positions: int
) -> Iterator[PackedBatch]:
    """Re-batch a (codes, rec_ends, ids) chunk stream into UNIFORM
    batch_positions-sized batches, carrying the remainder across chunk
    boundaries (with the usual (k-1) halo at every split).

    Without this, every ingest chunk ends in a remainder batch whose
    power-of-two bucket varies chunk to chunk, and each new
    (bucket, forest-depth) pair is a fresh XLA program to compile.
    Uniform batches keep the compiled-program set to one bucket (+ the
    single file tail).
    """
    buf: list[np.ndarray] = []
    total = 0
    for codes, _rec_ends, _ids in chunks:
        buf.append(codes)
        total += codes.shape[0]
        while total >= batch_positions:
            cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
            piece = cat[:batch_positions]
            yield PackedBatch(
                codes=piece,
                invalid=piece == codec.INVALID_CODE,
                owner=None,
                first_rid=0,
                record_ids=None,
            )
            rest = cat[batch_positions - (k - 1) :]  # halo at the split
            buf = [rest]
            total = rest.shape[0]
    if total:
        cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
        yield PackedBatch(
            codes=cat,
            invalid=cat == codec.INVALID_CODE,
            owner=None,
            first_rid=0,
            record_ids=None,
        )


def stream_file_batches(
    path,
    k: int,
    normalize: bool = True,
    batch_positions: int = 0,
    with_owner: bool = False,
) -> Iterator[PackedBatch]:
    """File -> PackedBatch stream via the native C++ tokenizer when
    available (one pass, zero Python per record, O(chunk) memory), else
    the line-streaming Python parser (O(record) memory)."""
    batch_positions = batch_positions or default_batch()
    from .ingest import native
    from .ingest.fastx import FastxParseError

    native_err = native.NativeParseError  # bind before the generator loop
    if native.available():
        try:
            chunks = stream_native_chunks(path, k, normalize)
            if not with_owner:
                # uniform batch sizes across chunk boundaries (see
                # _rebatch_codes) -- counting is record-agnostic
                yield from _rebatch_codes(chunks, k, batch_positions)
                return
            rid_offset = 0
            for codes, rec_ends, ids in chunks:
                yield from _iter_batches_from_packed(
                    codes, rec_ends, ids, k, batch_positions, with_owner, rid_offset
                )
                rid_offset += len(ids)
        except native_err as e:
            raise FastxParseError(str(e)) from e
        except ContextError as e:
            raise FastxParseError(
                f"Failed to get input reader for file: {path}", e
            ) from e
    else:
        yield from iter_packed_batches(
            parse_fastx_file(path),
            k,
            normalize=normalize,
            batch_positions=batch_positions,
            with_owner=with_owner,
        )


def _merge_sorted_unique_runs(v1, c1, v2, c2):
    """Merge two sorted-unique (vals, counts) runs, summing counts of
    values present in both.

    Native two-pointer pass when available (a linear memory-bound scan;
    measured 2x20M in ~0.3 s warm, first-touch page faults on the fresh
    output add ~2-4 s cold).  Fallback: searchsorted-based interleave
    -- O(n log n) comparisons but NO argsort over the concatenation
    (argsort re-derives the order the runs already have and allocates 3x
    the data); its 20M binary searches into 20M keys are cache-hostile
    on the 1-core host (measured 18.3 s for the same merge), which made
    the host tier a real fraction of the 1 Gbp CLI run's flush tail."""
    n1, n2 = v1.shape[0], v2.shape[0]
    if n1 == 0:
        return v2, c2
    if n2 == 0:
        return v1, c1
    from .ingest import native

    if native.available():
        return native.merge_unique(v1, c1, v2, c2)
    out_v = np.empty(n1 + n2, dtype=v1.dtype)
    out_c = np.empty(n1 + n2, dtype=np.int64)
    i1 = np.searchsorted(v2, v1, side="left") + np.arange(n1)
    i2 = np.searchsorted(v1, v2, side="right") + np.arange(n2)
    out_v[i1] = v1
    out_v[i2] = v2
    out_c[i1] = c1
    out_c[i2] = c2
    head = np.empty(n1 + n2, dtype=bool)
    head[0] = True
    np.not_equal(out_v[1:], out_v[:-1], out=head[1:])
    idx = np.flatnonzero(head)
    if idx.shape[0] == n1 + n2:  # disjoint values: nothing to collapse
        return out_v, out_c
    return out_v[idx], np.add.reduceat(out_c, idx)


class CountAccumulator:
    """Merge per-flush sorted-unique (vals, counts) runs.

    result() reduces the runs smallest-pair-first with sorted merges
    (each run is already sorted; a concat+argsort would re-derive known
    order and peak at ~4x the data -- at config-5 scale that is tens of
    GB on a 1-core host).  Merged inputs are released immediately, so
    peak extra memory is ~the final output + the two inputs of the
    current merge."""

    # consolidate when held entries exceed max(2x last consolidated
    # size, this floor): without it, a high-coverage input re-lists its
    # genome k-mers in EVERY flush epoch and host memory grows with
    # epochs, not with the table (measured 31 GB vs a ~5 GB table on a
    # 10 Gbp run).  Amortized O(n log epochs), same shape as the LSM.
    CONSOLIDATE_FLOOR = 1 << 25

    def __init__(self):
        self._vals: list[np.ndarray] = []
        self._counts: list[np.ndarray] = []
        self._total = 0
        self._threshold = self.CONSOLIDATE_FLOOR

    def add(self, vals: np.ndarray, counts: np.ndarray) -> None:
        if vals.shape[0]:
            self._vals.append(vals)
            self._counts.append(counts.astype(np.int64))
            self._total += vals.shape[0]
            if self._total > self._threshold:
                self._consolidate()

    def _merge_all(self) -> tuple[np.ndarray, np.ndarray]:
        from .ingest import native

        if (
            1 < len(self._vals) <= native.MAX_KWAY
            and native.available()
        ):
            # one native pass, ONE output allocation: fresh-buffer page
            # faults cost ~10x the merge scan on this host, and the
            # pairwise reduction below re-pays them every level
            return native.merge_unique_kway(self._vals, self._counts)
        runs = list(zip(self._vals, self._counts))
        while len(runs) > 1:
            runs.sort(key=lambda vc: vc[0].shape[0], reverse=True)
            v2, c2 = runs.pop()
            v1, c1 = runs.pop()
            runs.append(_merge_sorted_unique_runs(v1, c1, v2, c2))
        return runs[0]

    def _consolidate(self) -> None:
        v, c = self._merge_all()
        self._vals, self._counts = [v], [c]
        self._total = v.shape[0]
        self._threshold = max(2 * self._total, self.CONSOLIDATE_FLOOR)

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._vals:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        return self._merge_all()


def _fetch_counts_narrow(clo, n=None) -> np.ndarray:
    """Fetch a count plane at the narrowest dtype that holds its max
    (one device scalar probe; counts are overwhelmingly small, so the
    link usually carries 1 B/key instead of 4).

    ``n`` (if given) must be a BUCKETED length (power-of-two set): every
    eager op here compiles one program per (shape, dtype), so
    data-dependent exact lengths would compile a program per input (the
    same program-set rule as engine._rebatch_codes / flush's _bucket)."""
    sl = clo if n is None else clo[:n]
    cmax = int(jnp.max(sl))
    if cmax < (1 << 8):
        return np.asarray(sl.astype(jnp.uint8))
    if cmax < (1 << 16):
        return np.asarray(sl.astype(jnp.uint16))
    return np.asarray(sl)


class DeviceCountTable:
    """Device-resident count accumulation as an LSM-style merge forest.

    Each batch becomes a raw ascending weight-1 k-mer stream on device
    (ops.count.sort_canonical_packed); runs of equal capacity merge
    pairwise into a run of double capacity (ops.merge.merge_sorted_streams),
    binary-counter style.  Duplicates ride along unmerged: run-length
    encoding happens exactly once per flush (ops.count.rle_compact),
    since deduplication never shrinks the fixed-capacity device arrays.

    Every element participates in O(log(total/batch)) merges, no
    blocking host syncs happen mid-stream (valid counts stay as device
    scalars), and the host sees data only at flush.  The flush bound
    keeps per-key counts within int32 and the raw streams within a share
    of device memory (backend.flush_windows).
    """

    # None = derived from the device's memory (backend.flush_windows /
    # backend.device_table_max).  Past DEVICE_TABLE_MAX keys the
    # accumulated table is fetched to the host and the device side
    # restarts (the host accumulator is the overflow tier).
    FLUSH_WINDOWS: int | None = None
    DEVICE_TABLE_MAX: int | None = (
        int(os.environ.get("ORION_KMER_DEVICE_TABLE_MAX", 0)) or None
    )

    def _flush_windows(self) -> int:
        from . import backend

        return self.FLUSH_WINDOWS or backend.flush_windows()

    def _device_table_max(self) -> int:
        from . import backend

        return self.DEVICE_TABLE_MAX or backend.device_table_max()

    def __init__(self, k: int):
        self.k = k
        # 2k <= 32: the whole canonical k-mer fits one u32 plane
        # (ops/kmers.py:155-157), so runs carry a single value plane --
        # half the sort/merge/RLE bandwidth (the sort was ~45% of the
        # round-1 pipeline).  Run tuple: (lo, n_dev) vs (hi, lo, n_dev).
        self._single = 2 * k <= 32
        # 32 < 2k <= 48: keys are narrowed to a (t u32, b u16) pair for
        # the chunk sorts (ops.count.narrow_u48; k=21 is half the
        # BASELINE.json north-star) -- the merge forest / RLE / combine
        # path is the pair path verbatim on (t, b), and only _spill's
        # u64 reconstruction differs
        self._u48 = 32 < 2 * k <= 48
        self._tuple_len = 2 if self._single else 3
        # capacity (power of two) -> run tuple
        self._runs: dict[int, tuple] = {}
        self._windows_since_flush = 0
        self._acc = CountAccumulator()
        # device-resident accumulated table: keys... + (cnt_lo, cnt_hi)
        # u32 planes + device n; flush folds epoch RLE outputs into it so
        # the host link carries the table once, at result()
        self._table: tuple | None = None

    def update(self, codes: np.ndarray):
        n = codes.shape[0]
        if n == 0:
            return
        size = _bucket(n)
        lanes, inv_words = pack_for_transfer(codes, size)
        self.update_packed(jnp.asarray(lanes), jnp.asarray(inv_words), size, n)

    def _sort_batch(self, lanes, inv_words):
        """One jitted program per k-class: extract + sort the batch."""
        if self._single:
            from .ops.count import sort_canonical_packed_single

            return sort_canonical_packed_single(lanes, inv_words, self.k)
        if self._u48:
            from .ops.count import sort_canonical_packed_u48

            return sort_canonical_packed_u48(lanes, inv_words, self.k)
        from .ops.count import sort_canonical_packed

        return sort_canonical_packed(lanes, inv_words, self.k)

    def _merge_runs(self, a: tuple, b: tuple) -> tuple:
        """Merge two equal-capacity runs with one per-size merge program
        (shared by every fold that reaches that size)."""
        if self._single:
            from .ops.merge import merge_sorted_single

            return (merge_sorted_single(a[0], b[0]), a[1] + b[1])
        from .ops.merge import merge_sorted_streams

        mhi, mlo = merge_sorted_streams(a[0], a[1], b[0], b[1])
        return (mhi, mlo, a[2] + b[2])

    def update_packed(self, lanes, inv_words, size: int, n_windows: int):
        """Fold one wire-format batch in (size = 16 * len(lanes))."""
        run = self._sort_batch(lanes, inv_words)
        cap = size
        while cap in self._runs:
            run = self._merge_runs(self._runs.pop(cap), run)
            cap *= 2
        self._runs[cap] = run
        self._windows_since_flush += n_windows
        if self._windows_since_flush >= self._flush_windows():
            self.flush()

    @staticmethod
    def _pad_to(planes, cap: int):
        """Pad key/count planes up to ``cap`` elements (SENTINEL keys,
        zero counts) so combine-merge operands stay power-of-two sized."""
        n = planes[0].shape[0]
        if cap == n:
            return planes
        pad = cap - n
        out = []
        for i, p in enumerate(planes):
            fill = 0xFFFFFFFF if i < len(planes) - 2 else 0  # keys vs counts
            out.append(jnp.concatenate([p, jnp.full((pad,), fill, jnp.uint32)]))
        return out

    @classmethod
    def _pad_pow2(cls, planes, n_elems: int):
        """Pad planes up to the next power of two."""
        return cls._pad_to(planes, 1 << max(n_elems - 1, 1).bit_length())

    def _fold_into_table(self, key_planes, ucnt, n_u):
        """Merge one epoch's RLE output into the device-resident table,
        spilling to the host accumulator at the capacity bound."""
        from .ops.count import combine_sorted_unique, combine_sorted_unique_single

        clo = ucnt.astype(jnp.uint32)
        chi = jnp.zeros_like(clo)
        run = self._pad_pow2([*key_planes, clo, chi], key_planes[0].shape[0])
        if self._table is None:
            self._table = (*run, n_u)
            return
        t = self._table
        # equal caps keep the merged total a power of two (one compiled
        # combine per size); padding the smaller side costs <= 2x the
        # smaller operand
        cap = max(t[0].shape[0], run[0].shape[0])
        cap_out = 2 * cap
        if cap_out > self._device_table_max():
            self._spill()
            self._table = (*run, n_u)
            return
        t = (*self._pad_to(list(t[:-1]), cap), t[-1])
        run = self._pad_to(run, cap)
        if self._single:
            out = combine_sorted_unique_single(t[0], t[1], t[2], t[3], *run, n_u)
        else:
            out = combine_sorted_unique(
                t[0], t[1], t[2], t[3], t[4], *run, n_u
            )
        planes, n_new = out[:-1], out[-1]
        self._table = (*self._pad_pow2(list(planes), planes[0].shape[0]), n_new)

    def _spill(self):
        """Fetch the device table into the host accumulator and reset."""
        if self._table is None:
            return
        *planes, n_dev = self._table
        n = int(n_dev)
        if n:
            # device slices use the BUCKETED length, not the exact n:
            # every eager slice/cast compiles one program per shape, and
            # exact unique counts differ per input; bucketed lengths
            # keep the program set bounded at <= 2x the tight link
            # bytes.  The host trims to n after the fetch (pads are
            # SENTINEL/0).
            t = min(_bucket(n), planes[0].shape[0])
            if self._single:
                vals = np.asarray(planes[0][:t])[:n].astype(np.uint64)
                clo, chi = planes[1], planes[2]
            elif self._u48:
                from .ops.count import widen_u48_np

                # the b plane holds <= 16 live bits on this path: cast
                # to u16 ON DEVICE so the link carries 2 B/key, not 4
                vals = widen_u48_np(
                    np.asarray(planes[0][:t])[:n],
                    np.asarray(planes[1][:t].astype(jnp.uint16))[:n],
                    self.k,
                )
                clo, chi = planes[2], planes[3]
            else:
                vals = join_u64(
                    np.asarray(planes[0][:t])[:n], np.asarray(planes[1][:t])[:n]
                )
                clo, chi = planes[2], planes[3]
            counts = _fetch_counts_narrow(clo, t)[:n].astype(np.int64)
            # the high count plane is all-zero unless some k-mer passed
            # 2^32 occurrences: probe with one device scalar instead of
            # always fetching 4 B/key
            if bool(jnp.any(chi[:t] != 0)):
                counts += np.asarray(chi[:t])[:n].astype(np.int64) << 32
            self._acc.add(vals, counts)
        self._table = None

    def flush(self):
        from .ops.count import rle_compact, rle_compact_single

        for cap in sorted(self._runs):
            if self._single:
                lo, n_dev = self._runs[cap]
                ulo, ucnt, n_u = rle_compact_single(lo, n_dev)
                key_planes, cnt = [ulo], ucnt
            else:
                hi, lo, n_dev = self._runs[cap]
                uhi, ulo, ucnt, n_u = rle_compact(hi, lo, n_dev)
                key_planes, cnt = [uhi, ulo], ucnt
            # one scalar sync per epoch: slice the full-capacity RLE
            # buffers down to a tight bucket before folding, else the
            # table capacity tracks the 2^28 flush window instead of the
            # actual unique count (OOM'd at 1 Gbp scale)
            n = int(n_u)
            if n == 0:
                continue
            tight = _bucket(n)
            if tight < key_planes[0].shape[0]:
                key_planes = [p[:tight] for p in key_planes]
                cnt = cnt[:tight]
            self._fold_into_table(key_planes, cnt, jnp.int32(n))
        self._runs = {}
        self._windows_since_flush = 0

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        self.flush()
        self._spill()
        return self._acc.result()


def _prefetch(iterator, depth: int | None = None):
    """Run an iterator on a background thread with a bounded queue so host
    parse/pack overlaps device compute (PP stage overlap, SURVEY 2.3).
    Queue depth follows -t/--threads (ORION_KMER_THREADS; min 2)."""
    import queue
    import threading

    if depth is None:
        from .utils.progress import worker_threads

        depth = max(2, worker_threads(default=2))
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    t.join()
    if err:
        raise err[0]


def _make_count_table(k: int):
    """DeviceCountTable on one device; ShardedCountTable over the mesh
    when several devices are available (ORION_KMER_SHARDS: auto [default]
    = backend.auto_shards, i.e. every GPU of the host; 0 = force one
    device; N = first N devices of any platform -- the CPU-mesh tests
    use explicit N)."""
    from . import backend

    mode = os.environ.get("ORION_KMER_SHARDS", "auto")
    if mode != "0":
        n_dev = len(jax.devices())
        want = None
        if mode == "auto":
            want = backend.auto_shards(n_dev)
        elif mode.isdigit() and int(mode) > 1:
            want = min(int(mode), n_dev)
        if want is not None and want > 1:
            from .parallel.mesh import make_mesh
            from .parallel.streaming import ShardedCountTable

            return ShardedCountTable(k, mesh=make_mesh(n_devices=want))
    return DeviceCountTable(k)


def _staged_batches(path, k: int, normalize: bool):
    """Parse, wire-pack, AND device-transfer batches on the prefetch
    thread: jnp.asarray inside the generator starts the host->device
    copy before the consumer dispatches, so the copy overlaps device
    compute.

    ORION_KMER_STAGE_THREADS=N (default backend.stage_threads)
    additionally fans the transfers over N threads with an
    order-preserving bounded window, so N copies can be in flight.
    Order and results are identical by construction.
    """
    env = os.environ.get("ORION_KMER_STAGE_THREADS")
    if env is not None:
        stage = max(1, int(env))
    else:
        from . import backend

        stage = backend.stage_threads()

    def packed():
        for batch in stream_file_batches(path, k, normalize=normalize):
            n = batch.codes.shape[0]
            size = _bucket(n)
            lanes, inv_words = pack_for_transfer(batch.codes, size)
            yield lanes, inv_words, size, n

    if stage == 1:
        for lanes, inv_words, size, n in packed():
            yield jnp.asarray(lanes), jnp.asarray(inv_words), size, n
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def to_dev(item):
        lanes, inv_words, size, n = item
        return jnp.asarray(lanes), jnp.asarray(inv_words), size, n

    with ThreadPoolExecutor(max_workers=stage) as ex:
        window: deque = deque()
        for item in packed():
            window.append(ex.submit(to_dev, item))
            # >= caps in-flight transfers at exactly ORION_KMER_STAGE_THREADS
            if len(window) >= stage:
                yield window.popleft().result()
        while window:
            yield window.popleft().result()


def count_file(path, k: int, normalize: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counts of one file via the fastest ingest path:
    native parse -> prefetch(parse+pack+transfer) -> device-resident
    accumulation -> one fetch.  Spans the device mesh automatically when
    several chips are present."""
    import logging
    import time

    logger = logging.getLogger("orion_kmer_tpu.engine")
    table = _make_count_table(k)
    positions = 0
    t0 = time.monotonic()
    last_log = t0
    if isinstance(table, DeviceCountTable):
        stream = _prefetch(_staged_batches(path, k, normalize))
        for lanes, inv_words, size, n in stream:
            table.update_packed(lanes, inv_words, size, n)
            positions += n
            now = time.monotonic()
            if now - last_log >= 30.0:
                logger.info(
                    "count progress: %.1fM positions dispatched (%.1f s)",
                    positions / 1e6,
                    now - t0,
                )
                last_log = now
    else:
        for batch in _prefetch(stream_file_batches(path, k, normalize=normalize)):
            table.update(batch.codes)
            positions += batch.codes.shape[0]
            now = time.monotonic()
            if now - last_log >= 30.0:
                logger.info(
                    "count progress: %.1fM positions dispatched (%.1f s)",
                    positions / 1e6,
                    now - t0,
                )
                last_log = now
    return table.result()


def unique_from_file(path, k: int) -> np.ndarray:
    """Unique canonical k-mers of one genome file (build.rs:23-78)."""
    vals, _ = count_file(path, k)
    return vals


def _query_db_device(db_vals: np.ndarray):
    from .ops.setops import check_db_sorted

    dbh, dbl = split_u64(db_vals)
    db_n = dbh.shape[0]
    check_db_sorted(dbh, dbl, np.ones(db_n, dtype=bool))
    db_size = _bucket(db_n, minimum=1)
    db_hi = jax.device_put(jnp.asarray(_pad(dbh, db_size, 0)))
    db_lo = jax.device_put(jnp.asarray(_pad(dbl, db_size, 0)))
    db_valid = jax.device_put(
        jnp.asarray(_pad(np.ones(db_n, dtype=bool), db_size, False))
    )
    return db_hi, db_lo, db_valid


from functools import partial


@partial(jax.jit, static_argnames=("k", "num_reads"))
def _query_step(codes, owner, db_hi, db_lo, db_valid, k: int, num_reads: int):
    """Fused single-dispatch query step: derive mask, extract, join, sum."""
    invalid = codes > 3
    hi, lo, valid = extract_canonical(codes, invalid, k)
    member = membership(hi, lo, valid, db_hi, db_lo, db_valid)
    return hits_per_read(member, owner, num_reads)


@partial(jax.jit, static_argnames=("k", "num_reads"))
def _query_step_packed(
    lanes, inv_words, local_starts, db_hi, db_lo, db_valid, k: int, num_reads: int,
    n_positions,
):
    """Wire-format query step: lane extraction + on-device read ownership.

    ``local_starts`` are the batch-local record start positions (first
    record clamped to 0; padding entries = batch size, past every real
    position), so no per-base owner array ever crosses the host link.
    """
    from .ops.kmers_lanes import extract_canonical_lanes

    W = lanes.shape[0]
    N = 16 * W
    hi, lo, valid = extract_canonical_lanes(lanes, inv_words, k, n_positions)
    member = membership(
        hi.reshape(-1), lo.reshape(-1), valid.reshape(-1), db_hi, db_lo, db_valid
    )
    # per-read sums: read regions are contiguous in position order, so
    # hits[r] = P[start[r+1]] - P[start[r]] over the member prefix sum
    # (two num_reads-sized gathers)
    member_pos = member.reshape(16, W).T.reshape(-1)  # (offset,lane) -> position
    prefix = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(member_pos.astype(jnp.int32))]
    )
    starts = jnp.clip(local_starts, 0, N)
    ends = jnp.concatenate([starts[1:], jnp.full((1,), N, jnp.int32)])
    ends = jnp.maximum(ends, starts)  # padding starts (=N) stay empty
    return prefix[ends] - prefix[starts]


def _query_batches(
    db_dev, batches: Iterable[PackedBatch], k: int, min_hits: int, eligible
) -> list[bytes]:
    """Shared query core over a PackedBatch stream.

    ``eligible(grid) -> bool`` implements the reads-shorter-than-k drop
    (query.rs:83-85), which matters when min_hits == 0.
    """
    db_hi, db_lo, db_valid = db_dev
    all_ids: dict[int, bytes] = {}
    all_hits: dict[int, int] = {}
    for batch in batches:
        n = batch.codes.shape[0]
        size = _bucket(n)
        codes_p = jnp.asarray(_pad(batch.codes, size, codec.INVALID_CODE))
        owner_p = jnp.asarray(_pad(batch.owner, size, len(batch.record_ids)))
        nr = len(batch.record_ids)
        nr_bucket = _bucket(nr + 1, minimum=_READS_BUCKET)
        hits = np.asarray(
            _query_step(codes_p, owner_p, db_hi, db_lo, db_valid, k, nr_bucket)
        )
        for local, rid_bytes in enumerate(batch.record_ids):
            grid = batch.first_rid + local
            all_ids[grid] = rid_bytes
            all_hits[grid] = all_hits.get(grid, 0) + int(hits[local])
    return [
        all_ids[g] for g in sorted(all_ids) if all_hits[g] >= min_hits and eligible(g)
    ]


def query_records(
    db_vals: np.ndarray,
    records: Iterable[Record],
    k: int,
    min_hits: int,
) -> list[bytes]:
    """IDs of reads with >= min_hits matching windows (multiplicity
    counted, query.rs:87-103).  Reads shorter than k never match.
    Output preserves input read order (query.rs:119-123).
    Note: query uses RAW read bytes -- no normalization (query.rs:80-81).
    """
    records = list(records)
    lens = [len(r.seq) for r in records]
    db_dev = _query_db_device(db_vals)
    batches = iter_packed_batches(records, k, normalize=False, with_owner=True)
    return _query_batches(db_dev, batches, k, min_hits, lambda g: lens[g] >= k)


def query_file(db_vals: np.ndarray, path, k: int, min_hits: int, batch_positions: int = 0) -> list[bytes]:
    """Native-ingest query path: streaming chunked C parse feeding the
    wire-format query step; memory is O(chunk), never O(reads file)
    (unlike query.rs:62-67, which reads all reads into RAM).

    Batches are UNIFORMLY batch_positions-sized across chunk boundaries
    (record starts carried in a rolling buffer), so mid-stream device
    programs stay one (size, reads-bucket) shape -- per-chunk tail
    batches each compiled a fresh program otherwise (same fix as
    engine._rebatch_codes for counting).
    """
    batch_positions = batch_positions or default_batch()
    from .ingest import native
    from .ingest.fastx import FastxParseError

    if not native.available():
        return query_records(db_vals, parse_fastx_file(path), k, min_hits)
    db_dev = _query_db_device(db_vals)
    sep = k - 1
    B = batch_positions
    all_ids: list[bytes] = []
    all_lens: list[int] = []
    hits = np.zeros(1024, dtype=np.int64)  # grown geometrically below
    # rolling coordinate space: positions relative to buf[0]; records
    # keep (start, region_end, rid) -- starts may go negative once a
    # record spans consumed batches (clamped to 0 at dispatch, matching
    # _query_step_packed's first-record contract)
    buf = np.empty(0, np.uint8)
    bstarts = np.empty(0, np.int64)
    bends = np.empty(0, np.int64)
    brids = np.empty(0, np.int64)

    def run_batch(piece: np.ndarray, starts_local: np.ndarray, rids: np.ndarray):
        n = piece.shape[0]
        size = _bucket(n)
        lanes, inv_words = pack_for_transfer(piece, size)
        nr = rids.shape[0]
        nr_bucket = _bucket(nr + 1, minimum=_READS_BUCKET)
        ls = _pad(
            np.maximum(starts_local, 0).astype(np.int32), nr_bucket, size
        )  # pad entries = out-of-range, dropped
        step = np.asarray(
            _query_step_packed(
                jnp.asarray(lanes),
                jnp.asarray(inv_words),
                jnp.asarray(ls),
                *db_dev,
                k,
                nr_bucket,
                jnp.int32(n),
            )
        )
        # vectorized accumulation: a per-record Python loop here is
        # O(reads) interpreter work per batch on a 1-core host (rids can
        # repeat across batches for halo-split records, so add.at, not
        # fancy-index assignment)
        np.add.at(hits, rids, step[:nr].astype(np.int64))

    try:
        for codes, rec_ends, ids in stream_native_chunks(
            path, k, normalize=False
        ):
            base = buf.shape[0]
            starts = np.concatenate([[0], rec_ends[:-1] + sep])
            rid_base = len(all_ids)
            all_ids.extend(ids)
            all_lens.extend((rec_ends - starts).tolist())
            if len(all_ids) > hits.shape[0]:
                hits = np.concatenate(
                    [hits, np.zeros(max(hits.shape[0], len(all_ids)), np.int64)]
                )
            buf = np.concatenate([buf, codes]) if base else codes
            bstarts = np.concatenate([bstarts, base + starts])
            bends = np.concatenate([bends, base + rec_ends + sep])
            brids = np.concatenate(
                [brids, rid_base + np.arange(len(ids), dtype=np.int64)]
            )
            while buf.shape[0] >= B:
                mask = bstarts < B
                run_batch(buf[:B], bstarts[mask], brids[mask])
                cut = B - sep  # halo: boundary windows produced once
                buf = buf[cut:]
                keep = bends > cut
                bstarts = bstarts[keep] - cut
                bends = bends[keep] - cut
                brids = brids[keep]
        if buf.shape[0]:
            run_batch(buf, bstarts, brids)
    except native.NativeParseError as e:
        raise FastxParseError(str(e)) from e
    except ContextError as e:
        raise FastxParseError(
            f"Failed to get input reader for file: {path}", e
        ) from e
    return [
        all_ids[i]
        for i in range(len(all_ids))
        if hits[i] >= min_hits and all_lens[i] >= k
    ]


class ClassifyJoiner:
    """Batched classify joins of reference sets against ONE input count
    table (classify.rs:224-236, all references of a DB in one dispatch).

    The input table is padded + shipped to the device ONCE at
    construction; each join() call takes the concatenated k-mers of many
    references and runs ops.setops.classify_join -- a single merge-join
    program returning bit-packed membership for every reference k-mer
    (member_q) and every input k-mer (member_db): one dispatch and two
    small bitmask fetches per database instead of R dispatches.

    Per-reference depth sums stay host-side and int64-exact: a matched
    reference k-mer IS an input k-mer, so its count is found with one
    searchsorted into the (sorted) input table.
    """

    # One dispatch covers up to this many concatenated reference k-mers;
    # larger databases chunk at reference boundaries (still O(refs/2^24)
    # dispatches, not O(refs)).
    MAX_JOIN = 1 << 24

    def __init__(self, input_vals: np.ndarray, input_counts: np.ndarray):
        self.vals = input_vals
        self.counts = input_counts
        self._n = int(input_vals.shape[0])
        if self._n:
            dh, dl = split_u64(input_vals)
            size = _bucket(self._n, minimum=_MIN_BUCKET)
            self._db = (
                jax.device_put(jnp.asarray(_pad(dh, size, 0))),
                jax.device_put(jnp.asarray(_pad(dl, size, 0))),
                jax.device_put(
                    jnp.asarray(_pad(np.ones(self._n, dtype=bool), size, False))
                ),
            )

    def join(self, ref_vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """member masks (over ref_vals, over input table) in one dispatch."""
        from .ops.setops import classify_join

        nq = int(ref_vals.shape[0])
        if self._n == 0 or nq == 0:
            return np.zeros(nq, dtype=bool), np.zeros(self._n, dtype=bool)
        qh, ql = split_u64(ref_vals)
        qs = _bucket(nq, minimum=_MIN_BUCKET)
        bits_q, bits_db = classify_join(
            jnp.asarray(_pad(qh, qs, 0)),
            jnp.asarray(_pad(ql, qs, 0)),
            jnp.asarray(_pad(np.ones(nq, dtype=bool), qs, False)),
            *self._db,
        )
        member_q = np.unpackbits(
            np.asarray(bits_q).view(np.uint8), bitorder="little"
        )[:nq].astype(bool)
        member_db = np.unpackbits(
            np.asarray(bits_db).view(np.uint8), bitorder="little"
        )[: self._n].astype(bool)
        return member_q, member_db

    def depth_of(self, matched_vals: np.ndarray) -> int:
        """Summed input counts of matched k-mers, int64-exact
        (classify.rs:230-236 sum_depth).  matched_vals must all be
        present in the input table (they came from a join)."""
        if matched_vals.shape[0] == 0:
            return 0
        idx = np.searchsorted(self.vals, matched_vals)
        return int(self.counts[idx].sum())


def intersection_size_host(a: np.ndarray, b: np.ndarray) -> int:
    """Exact |A ∩ B| via the device merge join (compare.rs:58).

    Inputs must be sorted unique (DB dumps / count tables are).  Both
    sides are padded to a COMMON power-of-two bucket, so one compiled
    program serves every pair of inputs of that size."""
    from .ops.setops import intersection_size

    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0
    ah, al = split_u64(a)
    bh, bl = split_u64(b)
    size = max(_bucket(a.shape[0], minimum=1), _bucket(b.shape[0], minimum=1))
    res = intersection_size(
        jnp.asarray(_pad(ah, size, 0)),
        jnp.asarray(_pad(al, size, 0)),
        jnp.asarray(_pad(np.ones(a.shape[0], bool), size, False)),
        jnp.asarray(_pad(bh, size, 0)),
        jnp.asarray(_pad(bl, size, 0)),
        jnp.asarray(_pad(np.ones(b.shape[0], bool), size, False)),
    )
    return int(res)
