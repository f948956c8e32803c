"""Multi-chip sharded counting on the simulated 8-device CPU mesh.

Determinism tests replace race detection (SURVEY.md section 5): the same
input must produce identical counts on 1, 2, 4, and 8 shards.
"""

import jax
import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu.parallel import make_mesh, sharded_count


def _data(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.choice(list(b"ACGTN"), size=n).astype(np.uint8).tobytes()
    codes = codec.seq_to_codes(seq)
    return codes, codes == codec.INVALID_CODE


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [5, 21, 31])
def test_sharded_count_matches_oracle(n_dev, k):
    codes, invalid = _data()
    ref_vals = codec.extract_kmers_np(codes, k)
    exp_vals, exp_counts = np.unique(ref_vals, return_counts=True)
    mesh = make_mesh(n_devices=n_dev)
    vals, counts = sharded_count(codes, invalid, k, mesh=mesh)
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)


def test_sharded_count_shard_invariance():
    codes, invalid = _data(seed=7)
    k = 17
    results = []
    for n_dev in (1, 8):
        vals, counts = sharded_count(codes, invalid, k, mesh=make_mesh(n_devices=n_dev))
        results.append((vals, counts))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])


def test_mesh_has_8_cpu_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("k", [5, 21])
def test_all_to_all_path_matches_oracle(k):
    codes, invalid = _data(seed=11)
    ref_vals = codec.extract_kmers_np(codes, k)
    exp_vals, exp_counts = np.unique(ref_vals, return_counts=True)
    vals, counts = sharded_count(
        codes, invalid, k, mesh=make_mesh(n_devices=8), use_all_to_all=True
    )
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)


def test_all_to_all_overflow_retry_is_exact():
    # skewed input: one k-mer dominates -> its owner shard overflows a
    # tiny capacity; the retry/fallback chain must stay exact
    k = 7
    codes = codec.seq_to_codes(b"ACGTACG" * 800)  # highly repetitive
    invalid = codes == codec.INVALID_CODE
    exp_vals, exp_counts = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
    vals, counts = sharded_count(
        codes,
        invalid,
        k,
        mesh=make_mesh(n_devices=8),
        use_all_to_all=True,
        capacity_factor=0.05,  # force overflow on the first attempts
    )
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)


class TestShardedCountTable:
    def test_streaming_matches_oracle(self):
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.parallel.streaming import ShardedCountTable
        from orion_kmer_tpu.parallel import make_mesh

        rng = np.random.default_rng(31)
        k = 17
        mesh = make_mesh(n_devices=8)
        table = ShardedCountTable(k, mesh=mesh)
        parts = []
        for _ in range(3):
            codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
            codes[rng.random(5000) < 0.02] = 255
            table.update(codes)
            parts.append(codes)
            parts.append(np.full(k - 1, 255, dtype=np.uint8))
        vals, cnts = table.result()
        ref = codec.extract_kmers_np(np.concatenate(parts), k)
        ev, ec = np.unique(ref, return_counts=True)
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(cnts, ec)

    def test_streaming_u48_route_k21(self):
        """k=21 streams through the narrowed (t u32, b u16) a2a route
        (25% less interconnect traffic); results + low-complexity equal-t ties
        must stay exact, including through a mid-stream flush."""
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.parallel.streaming import ShardedCountTable
        from orion_kmer_tpu.parallel import make_mesh

        rng = np.random.default_rng(41)
        k = 21
        table = ShardedCountTable(k, mesh=make_mesh(n_devices=8))
        assert table._u48
        codes = rng.integers(0, 4, size=8000, dtype=np.uint8)
        codes[rng.random(8000) < 0.02] = 255
        # poly-A stretch: equal-t keys where only the u16 b plane breaks
        # ties across the wire
        codes[1000:1400] = 0
        table.update(codes)
        table.flush()
        table.update(codes)
        vals, cnts = table.result()
        sep = np.full(k - 1, 255, dtype=np.uint8)
        ref = codec.extract_kmers_np(np.concatenate([codes, sep, codes]), k)
        ev, ec = np.unique(ref, return_counts=True)
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(cnts, ec)

    @pytest.mark.parametrize("k", [17, 21, 24])
    def test_streaming_u48_route_matches_oracle(self, k):
        """32 < 2k <= 48 always routes narrowed (t, b) keys; across the
        class, 8 shards equal the one-device engine and the oracle."""
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.engine import DeviceCountTable
        from orion_kmer_tpu.parallel import make_mesh
        from orion_kmer_tpu.parallel.streaming import ShardedCountTable

        rng = np.random.default_rng(43 + k)
        codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
        codes[rng.random(6000) < 0.03] = 255
        t = ShardedCountTable(k, mesh=make_mesh(n_devices=8))
        assert t.stats_report()["route"] == "u48"
        t.update(codes)
        vals, cnts = t.result()
        one = DeviceCountTable(k)
        one.update(codes)
        v1, c1 = one.result()
        ev, ec = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
        for v, c in ((vals, cnts), (v1, c1)):
            np.testing.assert_array_equal(v, ev)
            np.testing.assert_array_equal(c, ec)

    def test_shard_count_invariance(self):
        """1-device and 8-device streaming tables produce identical
        results (the determinism contract replacing race detection)."""
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.parallel.streaming import ShardedCountTable
        from orion_kmer_tpu.parallel import make_mesh

        rng = np.random.default_rng(32)
        k = 11
        codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
        codes[rng.random(6000) < 0.05] = 255
        res = []
        for nd in (1, 8):
            t = ShardedCountTable(k, mesh=make_mesh(n_devices=nd))
            t.update(codes)
            res.append(t.result())
        np.testing.assert_array_equal(res[0][0], res[1][0])
        np.testing.assert_array_equal(res[0][1], res[1][1])

    def test_chain_cache_reuses_programs_across_batches(self):
        """Equal-size batches reuse one cached route program and one merge
        / flush program per capacity; the stream stays oracle-exact."""
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.parallel import make_mesh
        from orion_kmer_tpu.parallel.streaming import ShardedCountTable

        rng = np.random.default_rng(34)
        k = 17
        t = ShardedCountTable(k, mesh=make_mesh(n_devices=4))
        batches = []
        for _ in range(4):
            codes = rng.integers(0, 4, size=2048, dtype=np.uint8)
            codes[rng.random(2048) < 0.02] = 255
            batches.append(codes)
            t.update(codes)
        kinds = [key[0] for key in t._chain_cache]
        assert kinds.count("route") == 1
        assert kinds.count("merge") == 2  # the two forest levels 4 batches reach
        vals, cnts = t.result()
        sep = np.full(k - 1, 255, np.uint8)
        allc = np.concatenate([x for b in batches for x in (b, sep)])
        ev, ec = np.unique(codec.extract_kmers_np(allc, k), return_counts=True)
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(cnts, ec)

    def test_mid_stream_flush_accumulates(self):
        from orion_kmer_tpu import codec
        from orion_kmer_tpu.parallel.streaming import ShardedCountTable
        from orion_kmer_tpu.parallel import make_mesh

        rng = np.random.default_rng(33)
        k = 7
        codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
        t = ShardedCountTable(k, mesh=make_mesh(n_devices=4))
        t.update(codes)
        t.flush()  # force an epoch boundary
        t.update(codes)  # same batch again: every count doubles
        vals, cnts = t.result()
        sep = np.full(k - 1, 255, dtype=np.uint8)
        ref = codec.extract_kmers_np(np.concatenate([codes, sep, codes]), k)
        ev, ec = np.unique(ref, return_counts=True)
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(cnts, ec)


def test_count_file_sharded_matches_single(tmp_path, monkeypatch):
    """ORION_KMER_SHARDS=8 routes count_file through the mesh; output
    must match the single-chip path byte-exactly."""
    from orion_kmer_tpu.engine import count_file

    rng = np.random.default_rng(44)
    lines = []
    for i in range(30):
        seq = "".join(rng.choice(list("ACGTN"), rng.integers(10, 400)))
        lines.append(f">r{i}\n{seq}\n")
    path = tmp_path / "reads.fasta"
    path.write_text("".join(lines))
    monkeypatch.setenv("ORION_KMER_SHARDS", "0")
    v1, c1 = count_file(path, 13)
    monkeypatch.setenv("ORION_KMER_SHARDS", "8")
    v2, c2 = count_file(path, 13)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(c1, c2)


def test_streaming_overflow_retry_is_exact():
    """A skewed batch (one k-mer dominates) overflows the a2a capacity at
    a tiny factor; the streaming table must retry and stay exact."""
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable
    from orion_kmer_tpu.parallel import make_mesh

    k = 9
    codes = np.zeros(4000, dtype=np.uint8)  # poly-A: every window identical
    codes[3000:] = np.random.default_rng(3).integers(0, 4, 1000)
    t = ShardedCountTable(k, mesh=make_mesh(n_devices=4), capacity_factor=0.05)
    t.update(codes)
    vals, cnts = t.result()
    ev, ec = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
    np.testing.assert_array_equal(vals, ev)
    np.testing.assert_array_equal(cnts, ec)


def test_streaming_auto_flush(monkeypatch):
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable
    from orion_kmer_tpu.parallel import make_mesh

    monkeypatch.setattr(ShardedCountTable, "FLUSH_WINDOWS", 5000)
    rng = np.random.default_rng(9)
    k = 11
    t = ShardedCountTable(k, mesh=make_mesh(n_devices=4))
    parts = []
    for _ in range(4):  # 4 x 4000 positions -> several auto-flushes
        codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
        t.update(codes)
        parts.append(codes)
        parts.append(np.full(k - 1, 255, dtype=np.uint8))
    assert t._windows_since_flush < 5000  # flush actually happened
    vals, cnts = t.result()
    ev, ec = np.unique(codec.extract_kmers_np(np.concatenate(parts), k), return_counts=True)
    np.testing.assert_array_equal(vals, ev)
    np.testing.assert_array_equal(cnts, ec)


def test_sharded_flush_jits_once_per_capacity():
    """VERDICT round 1 #5: flush must compile once per run capacity
    across a table's lifetime (a fresh closure per flush re-jitted every
    time)."""
    from orion_kmer_tpu.parallel.mesh import make_mesh
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    rng = np.random.default_rng(5)
    table = ShardedCountTable(7, mesh=make_mesh(n_devices=4))
    codes = rng.integers(0, 4, size=2048, dtype=np.uint8)
    table.update(codes)
    table.flush()
    flush_keys_1 = [k for k in table._chain_cache if k[0] == "flush"]
    fn_1 = [table._chain_cache[k] for k in flush_keys_1]
    table.update(codes)
    table.flush()
    flush_keys_2 = [k for k in table._chain_cache if k[0] == "flush"]
    assert flush_keys_1 == flush_keys_2  # same capacity -> same entry
    assert [table._chain_cache[k] for k in flush_keys_2] == fn_1  # reused


def test_pack_blocks_native_matches_numpy():
    from orion_kmer_tpu.ingest import native
    from orion_kmer_tpu.parallel.streaming import _pack_blocks
    from orion_kmer_tpu.engine import pack_for_transfer

    if not native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(8)
    S, stride = 4, 100
    block = -(-stride // 32) * 32
    codes = rng.integers(0, 6, size=(S, stride)).astype(np.uint8)
    invalid = rng.random((S, stride)) < 0.2
    lanes, invw = _pack_blocks(codes, invalid, block)
    for s in range(S):
        row = np.where(invalid[s], 255, codes[s]).astype(np.uint8)
        el, ei = pack_for_transfer(row, block)
        np.testing.assert_array_equal(lanes[s], el)
        np.testing.assert_array_equal(invw[s], ei)


def test_sharded_single_plane_k16_t16_edge():
    """k=16 sharded streaming: single-plane a2a (half the interconnect traffic) must
    stay exact, including T-runs (canonical(T^16) = A^16 = 0; SENTINEL
    can never be a canonical value, so it safely marks unfilled slots)."""
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.parallel.mesh import make_mesh
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    rng = np.random.default_rng(61)
    codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
    codes[:40] = 3  # T-run: T^16 windows
    codes[rng.random(6000) < 0.01] = 255
    k = 16
    results = []
    for nd in (2, 4):
        t = ShardedCountTable(k, mesh=make_mesh(n_devices=nd))
        t.update(codes[:2500])
        t.update(codes[2500:])
        results.append(t.result())
    sep = np.full(k - 1, 255, dtype=np.uint8)
    ref = codec.extract_kmers_np(
        np.concatenate([codes[:2500], sep, codes[2500:]]), k
    )
    ev, ec = np.unique(ref, return_counts=True)
    for vals, counts in results:
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(counts, ec)


def test_sharded_device_resident_table(monkeypatch):
    """VERDICT round 2 #2/#weak2: flush must fold epoch RLE outputs into
    the per-shard device table (no per-epoch host arrays), the host
    accumulator must stay O(table) across many epochs, and results must
    stay exact across a forced mid-run spill."""
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.parallel import make_mesh
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    monkeypatch.setattr(ShardedCountTable, "FLUSH_WINDOWS", 4000)
    rng = np.random.default_rng(21)
    for k in (11, 21):  # single-plane and pair representations
        t = ShardedCountTable(k, mesh=make_mesh(n_devices=4))
        parts = []
        for _ in range(6):  # 6 epochs through the device fold
            codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
            t.update(codes)
            t.flush()
            parts.append(codes)
            parts.append(np.full(k - 1, 255, dtype=np.uint8))
            # the host tier saw NOTHING yet: epochs fold on device
            assert t._acc._total == 0
            assert t._table is not None
            assert t._table[0].ndim == 2  # [S, cap] sharded planes
        # force a spill mid-run: subsequent epochs restart the table
        t._spill()
        assert t._acc._total > 0
        codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
        t.update(codes)
        parts.append(codes)
        parts.append(np.full(k - 1, 255, dtype=np.uint8))
        vals, cnts = t.result()
        ev, ec = np.unique(
            codec.extract_kmers_np(np.concatenate(parts), k), return_counts=True
        )
        np.testing.assert_array_equal(vals, ev)
        np.testing.assert_array_equal(cnts, ec)


def test_sharded_spill_at_capacity_bound(monkeypatch):
    """Exceeding DEVICE_TABLE_MAX spills to the host accumulator and
    restarts the device table; results stay exact."""
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.parallel import make_mesh
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    monkeypatch.setattr(ShardedCountTable, "DEVICE_TABLE_MAX", 8192)
    rng = np.random.default_rng(23)
    k = 15
    t = ShardedCountTable(k, mesh=make_mesh(n_devices=4))
    parts = []
    for _ in range(4):
        codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
        t.update(codes)
        t.flush()
        parts.append(codes)
        parts.append(np.full(k - 1, 255, dtype=np.uint8))
    assert t._acc._total > 0  # the bound forced at least one spill
    vals, cnts = t.result()
    ev, ec = np.unique(
        codec.extract_kmers_np(np.concatenate(parts), k), return_counts=True
    )
    np.testing.assert_array_equal(vals, ev)
    np.testing.assert_array_equal(cnts, ec)


def test_sharded_stats_accounting():
    """Per-stage byte/dispatch accounting (VERDICT r3 #6): counters are
    derived from static shapes, so exact expectations are computable.
    The u48 route must report 6 B/elem through the a2a (25% under the
    pair route's 8) and the interconnect share must be (S-1)/S of bytes sent."""
    import numpy as np

    from orion_kmer_tpu import codec
    from orion_kmer_tpu.parallel.mesh import make_mesh
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
    mesh = make_mesh(n_devices=8)

    t21 = ShardedCountTable(21, mesh=mesh)
    t21.update(codes)
    t21.update(codes)
    v, c = t21.result()
    ev, ec = np.unique(
        codec.extract_kmers_np(
            np.concatenate([codes, np.full(20, 255, np.uint8), codes]), 21
        ),
        return_counts=True,
    )
    assert np.array_equal(v, ev) and np.array_equal(c, ec)
    rep = t21.stats_report()
    assert rep["route"] == "u48" and rep["n_shards"] == 8
    assert rep["positions"] == 8192 and rep["updates"] == 2
    # no overflow on uniform-random data at factor 2
    assert rep["route_retries"] == 0
    assert rep["route_dispatches"] == 2
    # 6 B/elem narrowed pairs; interconnect share = (S-1)/S exactly
    assert rep["a2a_bytes_sent"] % 6 == 0
    assert rep["a2a_bytes_ici"] * 8 == rep["a2a_bytes_sent"] * 7
    # two equal-capacity runs merged once; flush RLE'd the merged run
    assert rep["merge_dispatches"] == 1
    assert rep["flush_dispatches"] == 1
    assert rep["fold_dispatches"] == 1  # promote of the first epoch
    assert rep["spills"] == 1 and rep["host_link_bytes"] > 0
    assert rep["ici_bytes_per_position"] > 0

    t31 = ShardedCountTable(31, mesh=mesh)
    t31.update(codes)
    t31.result()
    rep31 = t31.stats_report()
    assert rep31["route"] == "pair"
    # same element count per update; pair route ships 8 B/elem vs 6
    assert rep31["a2a_bytes_sent"] * 6 == rep["a2a_bytes_sent"] // 2 * 8

    t13 = ShardedCountTable(13, mesh=mesh)
    t13.update(codes)
    t13.result()
    rep13 = t13.stats_report()
    assert rep13["route"] == "single"
    assert rep13["a2a_bytes_sent"] * 6 == rep["a2a_bytes_sent"] // 2 * 4
