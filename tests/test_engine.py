"""Engine-level tests: batching halos, device-resident accumulation."""

import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu.engine import (
    CountAccumulator,
    DeviceCountTable,
    iter_packed_batches,
    stream_file_batches,
)
from orion_kmer_tpu.ingest.fastx import Record


def test_device_count_table_multi_batch():
    rng = np.random.default_rng(0)
    k = 21
    seq = rng.choice(list(b"ACGTN"), size=30000).astype(np.uint8).tobytes()
    codes = codec.seq_to_codes(seq)
    exp_vals, exp_counts = np.unique(
        codec.extract_kmers_np(codes, k), return_counts=True
    )

    table = DeviceCountTable(k)
    # feed in awkward chunk sizes with manual halos
    a = 0
    while a < len(codes):
        b = min(a + 7001, len(codes))
        table.update(codes[a:b])
        if b >= len(codes):
            break
        a = b - (k - 1)
    vals, counts = table.result()
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)


def test_device_count_table_flush_mid_stream():
    k = 5
    codes1 = codec.seq_to_codes(b"ACGTACGTACGT")
    codes2 = codec.seq_to_codes(b"ACGTACGTACGT")
    table = DeviceCountTable(k)
    table.update(codes1)
    table.flush()  # force host spill
    table.update(codes2)
    vals, counts = table.result()
    exp_vals, exp_counts = np.unique(
        np.concatenate(
            [codec.extract_kmers_np(codes1, k), codec.extract_kmers_np(codes2, k)]
        ),
        return_counts=True,
    )
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)


def test_device_count_table_empty():
    table = DeviceCountTable(7)
    vals, counts = table.result()
    assert vals.shape[0] == 0 and counts.shape[0] == 0


def test_halo_split_windows_once():
    # a single long record split across batches: every window exactly once
    k = 9
    rng = np.random.default_rng(3)
    seq = rng.choice(list(b"ACGT"), size=5000).astype(np.uint8).tobytes()
    rec = [Record(b"r1", seq)]
    acc = []
    for batch in iter_packed_batches(rec, k, batch_positions=640):
        acc.append(codec.extract_kmers_np(
            np.where(batch.invalid, codec.INVALID_CODE, batch.codes), k
        ))
    got = np.sort(np.concatenate(acc))
    exp = np.sort(codec.extract_kmers_np(codec.seq_to_codes(seq), k))
    np.testing.assert_array_equal(got, exp)


def test_separator_blocks_cross_record_windows():
    k = 4
    recs = [Record(b"a", b"ACGT"), Record(b"b", b"TTTT")]
    for batch in iter_packed_batches(recs, k):
        vals = codec.extract_kmers_np(
            np.where(batch.invalid, codec.INVALID_CODE, batch.codes), k
        )
    # only ACGT and TTTT->AAAA; no chimeric windows like CGTT
    assert set(vals.tolist()) == {
        codec.canonical_u64(codec.seq_to_u64(b"ACGT", 4), 4),
        codec.canonical_u64(codec.seq_to_u64(b"TTTT", 4), 4),
    }


def test_stream_file_batches_native_vs_python(tmp_path):
    from orion_kmer_tpu.ingest import native

    content = ">s1\nACGTACGTNNACGT\n>s2\nGGGGCCCCAAAA\n"
    p = tmp_path / "x.fa"
    p.write_text(content)
    k = 5

    def collect(batches):
        out = []
        for b in batches:
            out.append(
                codec.extract_kmers_np(
                    np.where(b.invalid, codec.INVALID_CODE, b.codes), k
                )
            )
        return np.sort(np.concatenate(out))

    got = collect(stream_file_batches(p, k))
    import os

    os.environ["ORION_KMER_NATIVE"] = "0"
    try:
        # python fallback path through iter_packed_batches
        from orion_kmer_tpu.ingest.fastx import parse_fastx_file

        exp = collect(iter_packed_batches(parse_fastx_file(p), k))
    finally:
        os.environ["ORION_KMER_NATIVE"] = "1"
    np.testing.assert_array_equal(got, exp)


def test_query_file_batch_split_exact(tmp_path):
    # reads spanning device-batch boundaries: hits must sum across batches
    import numpy as np

    from orion_kmer_tpu.engine import query_file

    rng = np.random.default_rng(5)
    k = 11
    db_seqs = ["".join(rng.choice(list("ACGT"), size=500)) for _ in range(3)]
    reads = []
    for i in range(40):
        src = db_seqs[i % 3]
        start = int(rng.integers(0, len(src) - 60))
        seq = src[start : start + 50 + int(rng.integers(0, 10))]
        if i % 5 == 0:
            seq = "".join(rng.choice(list("ACGT"), size=len(seq)))  # noise read
        reads.append((f"r{i}", seq))
    reads_file = tmp_path / "reads.fastq"
    reads_file.write_text(
        "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads)
    )

    db_vals = np.unique(
        np.concatenate(
            [
                codec.extract_kmers_np(codec.seq_to_codes(s.encode()), k)
                for s in db_seqs
            ]
        )
    )

    def oracle(min_hits):
        out = []
        for rid, seq in reads:
            km = codec.extract_kmers_np(
                codec.seq_to_codes(seq.encode(), normalize=False), k
            )
            hits = int(np.isin(km, db_vals).sum())
            if len(seq) >= k and hits >= min_hits:
                out.append(rid.encode())
        return out

    for min_hits in (1, 5, 40):
        got_small = query_file(db_vals, reads_file, k, min_hits, batch_positions=256)
        got_big = query_file(db_vals, reads_file, k, min_hits)
        assert got_small == oracle(min_hits), min_hits
        assert got_big == oracle(min_hits), min_hits


def test_device_count_table_across_flushes(monkeypatch):
    """Counts for k-mers seen before AND after a flush must sum exactly
    (flush hands partial counts to the host accumulator)."""
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.engine import DeviceCountTable

    monkeypatch.setattr(DeviceCountTable, "FLUSH_WINDOWS", 6000)
    rng = np.random.default_rng(21)
    k = 9
    table = DeviceCountTable(k)
    all_codes = []
    for _ in range(5):  # 5 batches of 4k positions -> several flushes
        codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
        codes[rng.random(4000) < 0.02] = 255
        table.update(codes)
        all_codes.append(codes)
        all_codes.append(np.full(k - 1, 255, dtype=np.uint8))  # separator
    vals, cnts = table.result()
    ref = codec.extract_kmers_np(np.concatenate(all_codes), k)
    ev, ec = np.unique(ref, return_counts=True)
    np.testing.assert_array_equal(vals, ev)
    np.testing.assert_array_equal(cnts, ec)


def test_count_accumulator_pairwise_merge_matches_bruteforce():
    """VERDICT round 1 #10: result() must merge the already-sorted runs
    (no concat+argsort) and still be exact with duplicates across runs."""
    from orion_kmer_tpu.engine import CountAccumulator

    rng = np.random.default_rng(31)
    acc = CountAccumulator()
    all_v, all_c = [], []
    for _ in range(7):
        n = int(rng.integers(1, 500))
        v = np.unique(rng.integers(0, 800, size=n, dtype=np.uint64))
        c = rng.integers(1, 100, size=v.shape[0]).astype(np.int64)
        acc.add(v, c)
        all_v.append(v)
        all_c.append(c)
    vals, counts = acc.result()
    cat_v = np.concatenate(all_v)
    cat_c = np.concatenate(all_c)
    exp_v = np.unique(cat_v)
    exp_c = np.array([cat_c[cat_v == x].sum() for x in exp_v])
    np.testing.assert_array_equal(vals, exp_v)
    np.testing.assert_array_equal(counts, exp_c)


@pytest.mark.parametrize("k", [7, 21, 31])
def test_device_count_table_repeated_flushes_fold_exactly(monkeypatch, k):
    """Several flush epochs fold into the device table through
    combine_sorted_unique (the first flush only seeds it), for each key
    class; the result stays oracle-exact."""
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.engine import DeviceCountTable

    monkeypatch.setattr(DeviceCountTable, "FLUSH_WINDOWS", 2000)
    rng = np.random.default_rng(100 + k)
    t = DeviceCountTable(k)
    batches = []
    for _ in range(5):
        codes = rng.integers(0, 4, size=1500, dtype=np.uint8)
        codes[rng.random(1500) < 0.02] = 255
        batches.append(codes)
        t.update(codes)
    folds = []
    orig = DeviceCountTable._fold_into_table
    monkeypatch.setattr(
        DeviceCountTable, "_fold_into_table",
        lambda self, *a: (folds.append(self._table is not None), orig(self, *a))[1],
    )
    t.update(batches[0])
    t.flush()
    vals, counts = t.result()
    assert True in folds  # at least one fold merged into an existing table
    sep = np.full(k - 1, 255, np.uint8)
    allc = np.concatenate([x for b in [*batches, batches[0]] for x in (b, sep)])
    ev, ec = np.unique(codec.extract_kmers_np(allc, k), return_counts=True)
    np.testing.assert_array_equal(vals, ev)
    np.testing.assert_array_equal(counts, ec)


def test_count_accumulator_consolidation_bounds_runs():
    """Epoch-duplicated runs must consolidate: held entries stay
    ~O(table), not O(epochs x table), with exact results."""
    from orion_kmer_tpu.engine import CountAccumulator

    rng = np.random.default_rng(77)
    acc = CountAccumulator()
    acc.CONSOLIDATE_FLOOR = 1000  # instance override for the test
    acc._threshold = 1000
    base = np.sort(rng.choice(np.arange(5000, dtype=np.uint64), 800, replace=False))
    total = {}
    for _epoch in range(40):
        c = rng.integers(1, 50, size=base.shape[0]).astype(np.int64)
        acc.add(base, c)
        for v, cc in zip(base.tolist(), c.tolist()):
            total[v] = total.get(v, 0) + cc
    # held entries bounded near the table size, not 40 epochs worth
    assert acc._total <= 4 * base.shape[0], acc._total
    vals, counts = acc.result()
    np.testing.assert_array_equal(vals, base)
    np.testing.assert_array_equal(counts, [total[v] for v in base.tolist()])


class TestDeviceResidentTable:
    def test_multi_epoch_counts_exact(self, monkeypatch):
        """Epoch RLE outputs fold into the device table; totals must be
        exact across many flush epochs (device-side combine)."""
        from orion_kmer_tpu.engine import DeviceCountTable

        for k in (7, 21):
            t = DeviceCountTable(k)
            monkeypatch.setattr(t, "FLUSH_WINDOWS", 1, raising=False)
            rng = np.random.default_rng(90 + k)
            total = {}
            from orion_kmer_tpu import codec

            for _epoch in range(5):
                codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
                t.update(codes)
                t.flush()  # one epoch per update
                for v, c in zip(*np.unique(
                    codec.extract_kmers_np(codes, k), return_counts=True
                )):
                    total[int(v)] = total.get(int(v), 0) + int(c)
            vals, counts = t.result()
            exp_v = np.array(sorted(total), dtype=np.uint64)
            np.testing.assert_array_equal(vals, exp_v)
            np.testing.assert_array_equal(
                counts, [total[int(v)] for v in exp_v]
            )

    def test_count_carry_past_u32(self):
        """64-bit count planes: folding counts past 2^32 must carry."""
        import jax.numpy as jnp

        from orion_kmer_tpu.ops.count import combine_sorted_unique

        S = 0xFFFFFFFF

        def table(key_lo, cnt_lo):
            # one valid entry + SENTINEL/0 tail (the combine contract)
            return [
                jnp.array([0, S, S, S], jnp.uint32),
                jnp.array([key_lo, S, S, S], jnp.uint32),
                jnp.array([cnt_lo, 0, 0, 0], jnp.uint32),
                jnp.zeros(4, jnp.uint32),
            ]

        a = table(7, 0xFFFFFFFF)
        out = combine_sorted_unique(*a, jnp.int32(1), *a, jnp.int32(1))
        hi_, lo_, clo, chi, n = out
        assert int(n) == 1
        got = (int(np.asarray(chi)[0]) << 32) + int(np.asarray(clo)[0])
        assert got == 2 * 0xFFFFFFFF  # carried into the high plane

    def test_spill_path(self, monkeypatch):
        """Past the capacity bound the table spills to the host tier and
        results stay exact."""
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.engine import DeviceCountTable

        t = DeviceCountTable(9)
        monkeypatch.setattr(t, "DEVICE_TABLE_MAX", 8192, raising=False)
        rng = np.random.default_rng(3)
        allk = []
        for _ in range(4):
            codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
            t.update(codes)
            t.flush()
            allk.append(codec.extract_kmers_np(codes, 9))
        assert t._acc._vals  # at least one spill happened
        vals, counts = t.result()
        ev, ec = np.unique(np.concatenate(allk), return_counts=True)
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(counts, ec)


def test_staged_batches_threaded_order_and_equality(tmp_path, monkeypatch):
    """ORION_KMER_STAGE_THREADS>1 fans transfers over a thread pool with
    an order-preserving window; batches must arrive in the same order
    with the same contents as the serial path (engine.py::_staged_batches)."""
    from orion_kmer_tpu.engine import _staged_batches

    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(n))) for n in rng.integers(200, 5000, size=40)]
    p = tmp_path / "many.fa"
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    k = 9

    # small batches force many staged items through the window
    # (batch_positions is an import-time default arg, so wrap the streamer)
    import functools

    monkeypatch.setattr(
        "orion_kmer_tpu.engine.stream_file_batches",
        functools.partial(stream_file_batches, batch_positions=1 << 12),
    )

    def collect():
        return [
            (np.asarray(lanes), np.asarray(inv), size, n)
            for lanes, inv, size, n in _staged_batches(p, k, True)
        ]

    monkeypatch.setenv("ORION_KMER_STAGE_THREADS", "1")
    serial = collect()
    monkeypatch.setenv("ORION_KMER_STAGE_THREADS", "4")
    staged = collect()
    assert len(serial) == len(staged) and len(serial) > 4
    for (l0, i0, s0, n0), (l1, i1, s1, n1) in zip(serial, staged):
        assert s0 == s1 and n0 == n1
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(i0, i1)


def test_spill_skips_zero_chi_and_carries_nonzero():
    """_spill probes the high count plane with one device scalar and
    only fetches it when some count passed 2^32; both branches must
    produce exact 64-bit counts."""
    import jax.numpy as jnp

    from orion_kmer_tpu.engine import DeviceCountTable

    S = 0xFFFFFFFF

    def mk_table(chi0):
        t = DeviceCountTable(31)
        t._table = (
            jnp.array([0, 1, S, S], jnp.uint32),      # hi
            jnp.array([7, 8, S, S], jnp.uint32),      # lo
            jnp.array([5, 6, 0, 0], jnp.uint32),      # cnt lo
            jnp.array([chi0, 0, 0, 0], jnp.uint32),   # cnt hi
            jnp.int32(2),
        )
        return t

    t = mk_table(0)
    t._spill()
    vals, counts = t._acc.result()
    assert vals.tolist() == [7, (1 << 32) | 8]
    assert counts.tolist() == [5, 6]

    t = mk_table(3)
    t._spill()
    vals, counts = t._acc.result()
    assert vals.tolist() == [7, (1 << 32) | 8]
    assert counts.tolist() == [(3 << 32) + 5, 6]


def test_spill_count_narrowing_branches():
    """_fetch_counts_narrow picks u8/u16/u32 by the device max; every
    branch must round-trip counts exactly."""
    import jax.numpy as jnp

    from orion_kmer_tpu.engine import DeviceCountTable

    S = 0xFFFFFFFF
    for c0 in (200, 60000, 70000, 5_000_000_000 % (1 << 32)):
        t = DeviceCountTable(31)
        t._table = (
            jnp.array([0, 1, S, S], jnp.uint32),
            jnp.array([7, 8, S, S], jnp.uint32),
            jnp.array([c0, 1, 0, 0], jnp.uint32),
            jnp.zeros(4, jnp.uint32),
            jnp.int32(2),
        )
        t._spill()
        vals, counts = t._acc.result()
        assert counts.tolist() == [c0, 1], c0


def test_sharded_spill_carries_nonzero_chi():
    """ShardedCountTable._spill: same probe; craft a 2-shard table with
    one count past 2^32 (the class's _spill only touches these attrs,
    so no mesh is needed)."""
    import jax.numpy as jnp

    from orion_kmer_tpu.engine import CountAccumulator
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    S = 0xFFFFFFFF
    t = object.__new__(ShardedCountTable)
    t._single = False
    t._u48 = False
    t.n_shards = 2
    t._acc = CountAccumulator()
    t.stats = {"spills": 0, "host_link_bytes": 0}
    t._table = (
        jnp.array([[0, S], [2, S]], jnp.uint32),   # hi
        jnp.array([[9, S], [4, S]], jnp.uint32),   # lo
        jnp.array([[1, 0], [2, 0]], jnp.uint32),   # cnt lo
        jnp.array([[0, 0], [7, 0]], jnp.uint32),   # cnt hi
        jnp.array([1, 1], jnp.int32),
    )
    t._spill()
    vals, counts = t._acc.result()
    assert vals.tolist() == [9, (2 << 32) | 4]
    assert counts.tolist() == [1, (7 << 32) + 2]
