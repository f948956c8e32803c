"""The platform decisions (orion_kmer_tpu.backend), the compile-cache
location, and the refusal of the GPU-only scripts to run elsewhere."""

import importlib
import os
import sys

import numpy as np
import pytest

from orion_kmer_tpu import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("plat", ["gpu", "cpu"])
def test_default_batch(plat):
    want = backend.GPU_BATCH if plat == "gpu" else backend.CPU_BATCH
    assert backend.default_batch(plat) == want


@pytest.mark.parametrize("plat,want", [("gpu", 4), ("cpu", 1)])
def test_auto_shards_uses_every_gpu(plat, want):
    assert backend.auto_shards(4, plat) == want


@pytest.mark.parametrize("plat", ["gpu", "cpu"])
def test_stage_threads(plat):
    want = backend.GPU_STAGE_THREADS if plat == "gpu" else 1
    assert backend.stage_threads(plat) == want


@pytest.mark.parametrize("name", ["cuda", "gpu"])
def test_platform_names_the_gpu(monkeypatch, name):
    monkeypatch.setattr(backend, "_configured_platform", lambda: name)
    assert backend.platform() == backend.GPU


def test_engine_reads_the_faked_platform(monkeypatch):
    """engine's choices (batch, shards, staging) go through backend."""
    from orion_kmer_tpu import engine
    from orion_kmer_tpu.parallel.streaming import ShardedCountTable

    monkeypatch.setattr(backend, "platform", lambda: backend.GPU)
    monkeypatch.setattr(engine, "_DEFAULT_BATCH", 0)
    monkeypatch.delenv("ORION_KMER_SHARDS", raising=False)
    monkeypatch.delenv("ORION_KMER_STAGE_THREADS", raising=False)
    assert engine.default_batch() == backend.GPU_BATCH
    assert isinstance(engine._make_count_table(31), ShardedCountTable)
    monkeypatch.setattr(backend, "platform", lambda: "cpu")
    assert isinstance(engine._make_count_table(31), engine.DeviceCountTable)


def test_memory_derived_sizes(monkeypatch):
    monkeypatch.setattr(backend, "device_memory_bytes", lambda: 60 << 30)
    fw, tm = backend.flush_windows(), backend.device_table_max()
    assert fw & (fw - 1) == 0 and tm & (tm - 1) == 0
    assert fw * backend.FOREST_BYTES_PER_WINDOW <= backend.FOREST_SHARE * (60 << 30)
    assert tm * backend.TABLE_BYTES_PER_KEY <= backend.TABLE_SHARE * (60 << 30)
    assert 2 * fw * backend.FOREST_BYTES_PER_WINDOW > backend.FOREST_SHARE * (60 << 30)
    assert 2 * tm * backend.TABLE_BYTES_PER_KEY > backend.TABLE_SHARE * (60 << 30)
    monkeypatch.setattr(backend, "device_memory_bytes", lambda: 1 << 50)
    assert backend.flush_windows() == 1 << 30  # int32 counts stay exact


def test_table_bounds_follow_backend(monkeypatch):
    from orion_kmer_tpu.engine import DeviceCountTable

    monkeypatch.setattr(backend, "flush_windows", lambda: 1234)
    monkeypatch.setattr(backend, "device_table_max", lambda: 5678)
    t = DeviceCountTable(21)
    assert (t._flush_windows(), t._device_table_max()) == (1234, 5678)
    monkeypatch.setattr(DeviceCountTable, "FLUSH_WINDOWS", 99)
    assert t._flush_windows() == 99


def _fresh_jaxcache(monkeypatch):
    from orion_kmer_tpu.utils import jaxcache

    jaxcache = importlib.reload(jaxcache)
    updates = {}
    import jax

    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    return jaxcache, updates


def test_jaxcache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jaxcache, updates = _fresh_jaxcache(monkeypatch)
    jaxcache.enable_persistent_cache()
    assert "jax_compilation_cache_dir" not in updates


def test_jaxcache_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcache, updates = _fresh_jaxcache(monkeypatch)
    jaxcache.enable_persistent_cache()
    assert updates["jax_compilation_cache_dir"] == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_bench_refuses_non_gpu(capsys):
    sys.path.insert(0, ROOT)
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
    assert "GPU" in capsys.readouterr().err


def test_chip_smoke_refuses_non_gpu(monkeypatch, capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_CHILD_ENV", {**os.environ, "JAX_PLATFORMS": "cpu"})
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert "FAILED" in out


def test_chip_smoke_data_is_deterministic_per_seed():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    g = cs.genome(7, 0, 5000)
    assert np.array_equal(g, cs.genome(7, 0, 5000))
    assert not np.array_equal(g, cs.genome(8, 0, 5000))
    a = cs.fastq_bytes(cs.read_chunk(g, 7, 3, 50), 0)
    assert a == cs.fastq_bytes(cs.read_chunk(g, 7, 3, 50), 0)
    assert a != cs.fastq_bytes(cs.read_chunk(g, 8, 3, 50), 0)
    # 0.2% substitutions: reads mostly match their genome window
    assert a.count(b"\n@r") == 49
