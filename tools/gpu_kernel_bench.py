#!/usr/bin/env python3
"""Times the device building blocks of the count pipeline on the GPU.

Each result is one JSON line on stdout (and in chiprun_out/kernel_bench.jsonl):

* merge: three plain-XLA merges of two sorted runs -- ``sort`` (lax.sort
  of the concatenation), ``rank`` (binary-search rank + one scatter per
  plane) and ``path`` (ops.merge: merge-path blocks + batched row sort)
  -- at 2^22..2^28 elements and 1, 2, 3, 5 planes, with the bytes a merge
  must move (read both runs, write one) over the time;
* compact: ops.merge.compact_left (cumsum + scatter) at three densities;
* memory: device bytes per element of the forest merge, flush RLE and
  table combine (compiled.memory_analysis());
* sort_kind: whether XLA hands 1-key and 2-key sorts to CUB, and the
  card's copy bandwidth.

tools/count_ab.py measures the batch and staging settings end to end.

    python tools/gpu_kernel_bench.py [--quick] [--only SECTION,...]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "kernel_bench.jsonl")


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def timeit(fn, *args, reps: int = 5):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), statistics.median(ts)


def sorted_runs(key, n: int, n_planes: int, n_keys: int):
    """Two ascending runs of n/2 elements each (many equal keys)."""
    import jax
    import jax.numpy as jnp

    runs = []
    for part in jax.random.split(key, 2):
        ks = jax.random.split(part, n_planes)
        m = n // 2
        hi = jnp.cumsum(jax.random.randint(ks[0], (m,), 0, 2)).astype(jnp.uint32)
        planes = [hi]
        if n_keys == 2:
            lo = jax.random.bits(ks[1], (m,), jnp.uint32)
            hi, lo = jax.lax.sort((hi, lo), num_keys=2)
            planes = [hi, lo]
        planes += [
            jax.random.bits(ks[i], (m,), jnp.uint32) for i in range(n_keys, n_planes)
        ]
        runs.append(planes)
    return runs


def merge_sort(a, b, n_keys):
    import jax
    import jax.numpy as jnp

    cat = tuple(jnp.concatenate([x, y]) for x, y in zip(a, b))
    return list(jax.lax.sort(cat, num_keys=n_keys))


def _rank(sorted_keys, query_keys, right: bool):
    """Number of sorted elements < (or <= when right) each query."""
    import jax
    import jax.numpy as jnp

    n = sorted_keys[0].shape[0]
    q = query_keys[0].shape[0]

    def step(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        s = [k[jnp.clip(mid, 0, n - 1)] for k in sorted_keys]
        if len(s) == 1:
            below = s[0] <= query_keys[0] if right else s[0] < query_keys[0]
        else:
            tie = s[1] <= query_keys[1] if right else s[1] < query_keys[1]
            below = (s[0] < query_keys[0]) | ((s[0] == query_keys[0]) & tie)
        go = (lo < hi) & below
        return jnp.where(go, mid + 1, lo), jnp.where((lo < hi) & ~below, mid, hi)

    lo = jnp.zeros(q, jnp.int32)
    hi = jnp.full(q, n, jnp.int32)
    lo, _ = jax.lax.fori_loop(0, n.bit_length() + 1, step, (lo, hi))
    return lo


def merge_rank(a, b, n_keys):
    import jax.numpy as jnp

    na, nb = a[0].shape[0], b[0].shape[0]
    da = jnp.arange(na, dtype=jnp.int32) + _rank(b[:n_keys], a[:n_keys], False)
    db = jnp.arange(nb, dtype=jnp.int32) + _rank(a[:n_keys], b[:n_keys], True)
    out = []
    for pa, pb in zip(a, b):
        o = jnp.zeros(na + nb, pa.dtype)
        o = o.at[da].set(pa, unique_indices=True)
        out.append(o.at[db].set(pb, unique_indices=True))
    return out


def bench_merge(quick: bool):
    import jax
    import jax.numpy as jnp

    from orion_kmer_tpu.ops import merge

    def path(a, b, n_keys):
        return merge.merge_sorted_planes(a, b, n_keys=n_keys)

    cands = {"sort": merge_sort, "rank": merge_rank, "path": path}
    sizes = [22, 24] if quick else [22, 24, 26, 28]
    shapes = [(1, 1), (2, 2), (3, 2), (5, 2)]
    key = jax.random.PRNGKey(0)
    for lg in sizes:
        for n_planes, n_keys in shapes:
            a, b = sorted_runs(key, 1 << lg, n_planes, n_keys)
            ref = None
            for name, fn in cands.items():
                f = jax.jit(lambda a, b, fn=fn: fn(a, b, n_keys))
                best, med = timeit(f, a, b)
                out = f(a, b)
                if ref is None:
                    ref = out
                exact = all(
                    bool(jnp.array_equal(x, y)) for x, y in zip(out[:n_keys], ref[:n_keys])
                )
                moved = 2 * (1 << lg) * n_planes * 4
                emit({
                    "kind": "merge", "cand": name, "log2_n": lg, "planes": n_planes,
                    "n_keys": n_keys, "best_s": best, "median_s": med,
                    "gbps": moved / best / 1e9, "keys_equal_sort": exact,
                })
                del out
            del a, b, ref
    # block width sweep of the merge-path candidate
    lg = 24 if quick else 26
    a, b = sorted_runs(key, 1 << lg, 2, 2)
    saved = merge.MERGE_BLOCK
    for T in (256, 512, 1024, 2048, 4096):
        merge.MERGE_BLOCK = T
        f = jax.jit(lambda a, b: merge.merge_sorted_planes(a, b, n_keys=2))
        best, med = timeit(f, a, b)
        emit({"kind": "merge_block", "block": T, "log2_n": lg, "planes": 2,
              "best_s": best, "median_s": med})
    merge.MERGE_BLOCK = saved


def bench_compact(quick: bool):
    import jax
    import jax.numpy as jnp

    from orion_kmer_tpu.ops.merge import compact_left as compact
    key = jax.random.PRNGKey(1)
    for lg in ([22, 25] if quick else [22, 25, 27]):
        n = 1 << lg
        planes = [jax.random.bits(k, (n,), jnp.uint32) for k in jax.random.split(key, 3)]
        for dens in (0.03, 0.5, 0.97):
            keep = jax.random.uniform(key, (n,)) < dens
            f = jax.jit(lambda p, k: compact(p, k))
            best, med = timeit(f, planes, keep)
            emit({"kind": "compact", "cand": "scatter", "log2_n": lg, "planes": 3,
                  "density": dens, "best_s": best, "median_s": med})


def bench_memory(quick: bool):
    """Device bytes per element of the forest merge, the flush RLE and
    the table combine, from the compiled programs' memory analysis."""
    import jax
    import jax.numpy as jnp

    from orion_kmer_tpu.ops import count, merge

    for lg in (24, 26):
        n = 1 << lg
        u = jax.ShapeDtypeStruct((n,), jnp.uint32)
        h = jax.ShapeDtypeStruct((n // 2,), jnp.uint32)
        i32 = jax.ShapeDtypeStruct((), jnp.int32)
        progs = {
            "merge_streams": (merge.merge_sorted_streams, (h, h, h, h)),
            "rle_compact": (count.rle_compact, (u, u, i32)),
            "combine_unique": (count.combine_sorted_unique, (h, h, h, h, i32) * 2),
        }
        for name, (fn, args) in progs.items():
            ma = fn.lower(*args).compile().memory_analysis()
            total = ma.argument_size_in_bytes + ma.output_size_in_bytes + ma.temp_size_in_bytes
            emit({"kind": "memory", "program": name, "log2_n": lg,
                  "temp_bytes": ma.temp_size_in_bytes,
                  "arg_bytes": ma.argument_size_in_bytes,
                  "out_bytes": ma.output_size_in_bytes,
                  "bytes_per_elem": total / n})


def bench_sort_kind():
    import jax
    import jax.numpy as jnp

    n = 1 << 24
    x = jax.random.bits(jax.random.PRNGKey(2), (n,), jnp.uint32)
    y = jax.random.bits(jax.random.PRNGKey(3), (n,), jnp.uint32)
    cases = {
        "1key": lambda x, y: jax.lax.sort((x,), num_keys=1),
        "1key_payload": lambda x, y: jax.lax.sort((x, y), num_keys=1),
        "2key": lambda x, y: jax.lax.sort((x, y), num_keys=2),
        "copy": lambda x, y: x + jnp.uint32(1),
    }
    for name, fn in cases.items():
        f = jax.jit(fn)
        txt = f.lower(x, y).compile().as_text().lower()
        best, med = timeit(f, x, y)
        emit({"kind": "sort_kind", "case": name, "log2_n": 24, "best_s": best,
              "median_s": med, "cub": "cub" in txt})
    big = jax.random.bits(jax.random.PRNGKey(4), (1 << 28,), jnp.uint32)
    best, _ = timeit(jax.jit(lambda v: v + jnp.uint32(1)), big)
    emit({"kind": "copy_bandwidth", "bytes": 2 * 4 << 28, "best_s": best,
          "gbps": (2 * 4 << 28) / best / 1e9})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer, smaller sizes")
    ap.add_argument("--only", default=None, help="comma list of sections")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    sys.path.insert(0, ROOT)
    import jax

    if jax.default_backend() != "gpu":
        print("gpu_kernel_bench: no GPU found", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    dev = jax.devices()[0]
    emit({"kind": "device", "nvidia_smi": smi, "device_kind": dev.device_kind,
          "bytes_limit": (dev.memory_stats() or {}).get("bytes_limit"),
          "jax": jax.__version__})
    sections = {
        "sort_kind": lambda q: bench_sort_kind(),
        "memory": bench_memory,
        "merge": bench_merge,
        "compact": bench_compact,
    }
    only = args.only.split(",") if args.only else list(sections)
    for name in only:
        t0 = time.perf_counter()
        sections[name](args.quick)
        print(f"# section {name}: {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
