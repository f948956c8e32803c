"""Device mesh construction.

The reference is single-host, shared-memory only (rayon threads,
utils.rs:28-33; SURVEY.md section 2.3).  The replacement here is a
jax.sharding.Mesh: one ``shard`` axis that serves simultaneously as the
data axis (read batches are position-sharded across it) and the table
axis (the 64-bit canonical-k-mer space is hash-range-partitioned across
it) -- the k-mer analog of combined DP+TP.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, only {len(devices)} available"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("shard",))
