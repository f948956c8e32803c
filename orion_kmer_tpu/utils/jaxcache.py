"""Persistent XLA compilation cache.

Every CLI / bench / engine process compiles the same programs; the
persistent cache lets a repeat invocation load them instead.  Where
JAX_COMPILATION_CACHE_DIR is set, JAX itself uses that directory and
nothing is set here; otherwise the cache lives in a fixed directory of
the checkout (CACHE_DIR, git-ignored).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

logger = logging.getLogger("orion_kmer_tpu.jaxcache")

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
_enabled = False


def enable_persistent_cache() -> None:
    global _enabled
    if _enabled:
        return
    _enabled = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    try:
        import jax

        CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception as e:  # noqa: BLE001 - cache is best-effort
        logger.debug("persistent compilation cache unavailable: %s", e)
