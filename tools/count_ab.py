#!/usr/bin/env python3
"""End-to-end A/B of the count CLI's platform settings on the GPU.

Generates config-2 reads (chip_smoke's generator: 4.6 Mbp genome, 150 bp
reads, 0.2% substitutions, gz FASTQ), then runs ``count -k 31 -m 2
--histogram`` under each setting in the order A B C ... C B A, checks
that every run wrote the same bytes, and reports wall times.  A last run
with ``--trace`` gives the device's busy and idle share.

    python tools/count_ab.py [--reads N] [--seed S]

Prints one JSON line per run and a summary line; writes them to
chiprun_out/count_ab.jsonl too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "count_ab.jsonl")

VARIANTS = {
    "batch22_stage1": {"ORION_KMER_BATCH": str(1 << 22), "ORION_KMER_STAGE_THREADS": "1"},
    "batch24_stage1": {"ORION_KMER_BATCH": str(1 << 24), "ORION_KMER_STAGE_THREADS": "1"},
    "batch24_stage4": {"ORION_KMER_BATCH": str(1 << 24), "ORION_KMER_STAGE_THREADS": "4"},
}


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def run_count(reads, out_dir, env, trace=None) -> float:
    args = [sys.executable, "-m", "orion_kmer_tpu"]
    if trace:
        args += ["--trace", trace]
    args += ["count", "-k", "31", "-m", "2", "--histogram", f"{out_dir}/h.txt",
             "-i", reads, "-o", f"{out_dir}/c.tsv"]
    t0 = time.perf_counter()
    subprocess.run(args, cwd=ROOT, env={**os.environ, **env}, check=True)
    return time.perf_counter() - t0


def device_busy(trace_dir: str) -> dict:
    """Busy/idle share of GPU 0 from a jax.profiler trace: busy is the
    union of the kernel intervals on the device's stream lines; the
    window is the traced span of all planes."""
    import jax

    path = glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb")[0]
    prof = jax.profiler.ProfileData.from_file(path)
    t_lo, t_hi, spans, lines = float("inf"), 0.0, [], []
    for plane in prof.planes:
        for line in plane.lines:
            for ev in line.events:
                t_lo = min(t_lo, ev.start_ns)
                t_hi = max(t_hi, ev.start_ns + ev.duration_ns)
        if plane.name.startswith("/device:GPU:0"):
            for line in plane.lines:
                lines.append(line.name)
                if "stream" in line.name.lower():
                    spans += [(e.start_ns, e.start_ns + e.duration_ns) for e in line.events]
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = t_hi - t_lo
    return {"device_lines": lines, "kernels": len(spans), "busy_s": busy / 1e9,
            "window_s": window / 1e9, "idle_share": 1 - busy / window if window else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    import chip_smoke as cs

    work = tempfile.mkdtemp(dir=ROOT, prefix=".count_ab_")
    reads = os.path.join(work, "reads.fq.gz")
    cs.write_reads(reads, cs.genome(args.seed, 0), args.seed, args.reads, gz=True)
    order = list(VARIANTS) + list(reversed(VARIANTS))
    walls: dict[str, list[float]] = {v: [] for v in VARIANTS}
    ref = None
    for i, name in enumerate(order):
        out_dir = os.path.join(work, f"run{i}")
        os.makedirs(out_dir)
        wall = run_count(reads, out_dir, VARIANTS[name])
        walls[name].append(wall)
        outs = [open(f"{out_dir}/{f}", "rb").read() for f in ("c.tsv", "h.txt")]
        same = ref is None or outs == ref
        ref = ref or outs
        emit({"kind": "count_run", "variant": name, "reads": args.reads,
              "wall_s": wall, "identical": same})
    trace = os.path.join(work, "trace")
    out_dir = os.path.join(work, "traced")
    os.makedirs(out_dir)
    wall = run_count(reads, out_dir, {}, trace=trace)
    emit({"kind": "count_traced", "reads": args.reads, "wall_s": wall, **device_busy(trace)})
    emit({"kind": "count_ab", "card": cs.card_name_and_power(), "walls": walls})
    subprocess.run(["rm", "-rf", work])
    return 0


if __name__ == "__main__":
    sys.exit(main())
