"""The one place that decides what depends on the platform.

The engine runs on an NVIDIA GPU ("gpu"); the CPU backend serves tests
and development.  Every size or switch that differs between the two is
chosen here, by naming the GPU explicitly -- nothing else in the package
compares backend names.  Each GPU value was measured on an H100 (see
PERF.md, "Re-derived sizes").
"""

from __future__ import annotations

import os

GPU = "gpu"

# Positions per device batch.
GPU_BATCH = 1 << 24
CPU_BATCH = 1 << 22

# Host threads that copy staged batches to the device.
GPU_STAGE_THREADS = 4

# Device bytes per raw window in the merge forest (8 B resident pair
# keys + the merge and flush programs' arguments, outputs and scratch:
# 20 and 24 B per element, compiled.memory_analysis() on an H100), and
# per device-table key (16 B resident + the combine program's 61 B per
# output slot, two output slots per key: 16 + 2 x 61 = 138).  Each is a
# share of the memory the device reports.
FOREST_BYTES_PER_WINDOW = 32
FOREST_SHARE = 0.25
TABLE_BYTES_PER_KEY = 138
TABLE_SHARE = 0.5
# Used where the device reports no memory size (the CPU backend).
FALLBACK_MEMORY_BYTES = 16 << 30


def platform() -> str:
    """The platform JAX runs on.  An explicit jax.config / JAX_PLATFORMS
    setting is read without starting a backend, so host-only helpers
    never initialise a device client."""
    p = _configured_platform()
    if p in ("cuda", "rocm"):
        return GPU
    if p:
        return p
    import jax

    return jax.default_backend()


def _configured_platform() -> str:
    import jax

    p = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return p.split(",")[0].strip().lower()


def default_batch(plat: str | None = None) -> int:
    return GPU_BATCH if (plat or platform()) == GPU else CPU_BATCH


def auto_shards(n_devices: int, plat: str | None = None) -> int:
    """Shards for ORION_KMER_SHARDS=auto: every GPU of the host; one on
    the CPU (the CPU-mesh tests ask for N explicitly)."""
    return n_devices if (plat or platform()) == GPU else 1


def stage_threads(plat: str | None = None) -> int:
    return GPU_STAGE_THREADS if (plat or platform()) == GPU else 1


def device_memory_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit") or FALLBACK_MEMORY_BYTES)


def _pow2_floor(x: float) -> int:
    return 1 << max(int(x).bit_length() - 1, 0)


def flush_windows() -> int:
    """Raw windows the merge forest holds before it flushes (below 2^31,
    so per-key counts stay exact in int32)."""
    share = FOREST_SHARE * device_memory_bytes() / FOREST_BYTES_PER_WINDOW
    return min(_pow2_floor(share), 1 << 30)


def device_table_max() -> int:
    """Keys the device-resident table holds before it spills to the host."""
    return _pow2_floor(TABLE_SHARE * device_memory_bytes() / TABLE_BYTES_PER_KEY)
