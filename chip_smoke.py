#!/usr/bin/env python3
"""Smoke run of the exact k-mer engine on one NVIDIA GPU.

Drives the normal entry points (``python -m orion_kmer_tpu ...`` and
``serve`` with ``--server`` clients) at deployment size and checks every
output against an independent numpy oracle (``codec.extract_kmers_np`` +
``np.unique`` / ``np.isin``, ``ops.sketch.sketch_np``).

Phases, each in its own subprocess so that one process holds the card
(the parent never starts JAX on the card; it runs the oracles on the CPU):

0. device: JAX's backend must be the GPU, and native ingest must load.
1. count: BASELINE config 2 -- a 4.6 Mbp genome, 6.7M reads of 150 bp
   (~1 Gbp) with 0.2% substitutions, gz FASTQ: ``count -k 31 -m 2
   --histogram``.  Its ~804M windows cross the merge forest's flush
   bound (backend.flush_windows, 2^28 on an 80 GB card) three times, so
   flush epochs fold into the device table.  Then k=21 (the u48 path)
   and k=15 (the single-plane path) on a 200k-read slice of the same
   reads.
2. database: ``build -k 31`` on 3 genomes, ``query -c 1``, ``classify
   --output-tsv``, ``compare`` (self: Jaccard 1.0), ``sketch --scaled
   1000`` + ``sketch-compare``, ``profile``.
3. serve: ``count``, ``classify`` and ``profile`` through ``--server``
   clients (which never open the card); each output must equal the
   fresh-process output of phases 1-2 byte for byte (profile: all but its
   wall-time fields).

``--gpus 4`` runs only the sharded path instead: ``count`` at k=31 (4.6M
reads, past two flush bounds), and at k=21 and 15 (a 200k-read slice),
with ORION_KMER_SHARDS=4 on multi-species reads with Zipf-skewed
abundance (BASELINE config 5 shape), against the one-card run and the
oracle.

Tolerance: every output is an integer or a float formatted on the host
from integers, and no phase has a matrix product, so TF32 does not
apply: every comparison is exact equality.

The last line of stdout is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed
phase exits non-zero before it is printed.

    python chip_smoke.py [--gpus 4] [--reads N] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / ".smoke_data"  # inputs and outputs, removed at the end
WORK = DATA / "out"

READ_LEN = 150
ERROR_RATE = 0.002
GENOME_LEN = 4_600_000
FULL_READS = 6_700_000  # x 150 bp = ~1 Gbp, BASELINE config 2
# --gpus 4: enough k=31 windows (120 per read) to pass 2 x 2^28
SHARDED_READS = 4_600_000
CHUNK_READS = 200_000
SLICE_READS = CHUNK_READS  # the slice is the first chunk of the reads
BUCKET_BITS = 4  # oracle partitions k-mers by their top bits
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CHILD_ENV = dict(os.environ)  # the CLI children see the caller's platform


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


# --------------------------------------------------------------- data


def genome(seed: int, idx: int, length: int | None = None) -> np.ndarray:
    """Random genome as 2-bit codes (0..3)."""
    rng = np.random.default_rng([seed, 1, idx])
    return rng.integers(0, 4, length or GENOME_LEN, dtype=np.uint8)


def mutate(g: np.ndarray, seed: int, rate: float) -> np.ndarray:
    rng = np.random.default_rng([seed, 3])
    out = g.copy()
    hit = rng.random(g.shape[0]) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) % 4
    return out


def read_chunk(src: np.ndarray, seed: int, chunk: int, n: int) -> np.ndarray:
    """n reads (n, READ_LEN) of codes: uniform starts on ``src`` (a
    genome, or several concatenated), half reverse-complemented, with
    ERROR_RATE substitutions."""
    rng = np.random.default_rng([seed, 2, chunk])
    starts = rng.integers(0, src.shape[0] - READ_LEN + 1, n)
    reads = src[starts[:, None] + np.arange(READ_LEN)]
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    err = rng.random(reads.shape) < ERROR_RATE
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()), dtype=np.uint8)) % 4
    return reads


def fastq_bytes(reads: np.ndarray, first_id: int) -> bytes:
    """Fixed-width FASTQ records: @r%08d, sequence, +, constant quality."""
    n = reads.shape[0]
    rec = np.empty((n, 2 * READ_LEN + 15), np.uint8)
    ids = first_id + np.arange(n, dtype=np.int64)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    rec[:, 2:10] = ids[:, None] // 10 ** np.arange(7, -1, -1) % 10 + ord("0")
    rec[:, 10] = 10
    rec[:, 11 : 11 + READ_LEN] = _ACGT[reads]
    rec[:, 11 + READ_LEN : 14 + READ_LEN] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 14 + READ_LEN : 14 + 2 * READ_LEN] = ord("I")
    rec[:, -1] = 10
    return rec.tobytes()


def fasta_bytes(name: str, g: np.ndarray) -> bytes:
    seq = _ACGT[g].tobytes()
    lines = [seq[i : i + 80] for i in range(0, len(seq), 80)]
    return b">" + name.encode() + b"\n" + b"\n".join(lines) + b"\n"


def _gz_member(data: bytes) -> bytes:
    c = zlib.compressobj(1, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def write_reads(path: Path, src: np.ndarray, seed: int, n_reads: int, gz: bool) -> None:
    """Reads in CHUNK_READS chunks; gz output is one gzip member per
    chunk, compressed in parallel (a multi-member file, as bgzip and
    pigz write)."""
    chunks = [(i, min(CHUNK_READS, n_reads - i * CHUNK_READS))
              for i in range(-(-n_reads // CHUNK_READS))]

    def make(ci):
        i, n = ci
        data = fastq_bytes(read_chunk(src, seed, i, n), i * CHUNK_READS)
        return _gz_member(data) if gz else data

    with open(path, "wb") as f, ThreadPoolExecutor(8) as ex:
        for blob in ex.map(make, chunks):
            f.write(blob)


# ------------------------------------------------------------- oracle


def _bucket_of(vals: np.ndarray, k: int) -> np.ndarray:
    return (vals >> np.uint64(2 * k - BUCKET_BITS)).astype(np.int64)


def _split_buckets(vals: np.ndarray, counts: np.ndarray, k: int):
    b = _bucket_of(vals, k)  # vals are sorted, so buckets are contiguous
    edges = np.searchsorted(b, np.arange((1 << BUCKET_BITS) + 1))
    return [(vals[edges[i] : edges[i + 1]], counts[edges[i] : edges[i + 1]])
            for i in range(1 << BUCKET_BITS)]


def _chunk_counts(job):
    """Worker: exact counts of one read chunk, split by value bucket."""
    from orion_kmer_tpu import codec

    src, seed, chunk, n, k = job
    reads = read_chunk(src, seed, chunk, n)
    codes = np.concatenate(
        [reads, np.full((n, 1), codec.INVALID_CODE, np.uint8)], axis=1
    ).reshape(-1)
    vals, counts = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
    return _split_buckets(vals, counts.astype(np.int64), k)


def _combine(parts):
    vals = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    order = np.argsort(vals, kind="stable")
    vals, counts = vals[order], counts[order]
    if vals.shape[0] == 0:
        return vals, counts
    head = np.empty(vals.shape[0], bool)
    head[0] = True
    np.not_equal(vals[1:], vals[:-1], out=head[1:])
    idx = np.flatnonzero(head)
    return vals[idx], np.add.reduceat(counts, idx)


def oracle_counts(src, seed, n_reads, k, pool):
    """Exact (sorted vals, counts) of the reads write_reads generates."""
    jobs = [(src, seed, i, min(CHUNK_READS, n_reads - i * CHUNK_READS), k)
            for i in range(-(-n_reads // CHUNK_READS))]
    per_chunk = list(pool.map(_chunk_counts, jobs))
    per_bucket = list(pool.map(
        _combine, [[c[b] for c in per_chunk] for b in range(1 << BUCKET_BITS)]
    ))
    vals = np.concatenate([v for v, _ in per_bucket])
    counts = np.concatenate([c for _, c in per_bucket])
    return vals, counts


def render_counts(vals: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    out = []
    for s in range(0, vals.shape[0], 1 << 20):
        v = vals[s : s + (1 << 20)]
        rows = _ACGT[((v[:, None] >> shifts) & np.uint64(3)).astype(np.uint8)]
        seqs = rows.tobytes()
        out.append(b"".join(
            seqs[i * k : (i + 1) * k] + b"\t%d\n" % c
            for i, c in enumerate(counts[s : s + (1 << 20)].tolist())
        ))
    return b"".join(out)


def render_histogram(counts: np.ndarray) -> bytes:
    m, f = np.unique(counts, return_counts=True)
    return b"".join(b"%d\t%d\n" % (a, b) for a, b in zip(m.tolist(), f.tolist()))


def genome_kmers(g: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    from orion_kmer_tpu import codec

    return np.unique(codec.extract_kmers_np(g, k), return_counts=True)


# ------------------------------------------------------------ running


def cli(args, env=None, timeout=1200) -> float:
    """Run one fresh CLI process; return its wall time."""
    cmd = [sys.executable, "-m", "orion_kmer_tpu", *map(str, args)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env={**_CHILD_ENV, **(env or {})},
                       capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if p.returncode != 0:
        raise SmokeFailure(f"{' '.join(cmd[2:])} exited {p.returncode}:\n{p.stderr[-3000:]}")
    return dt


def same_bytes(path: Path, want: bytes, what: str) -> None:
    got = path.read_bytes()
    check(got == want, f"{what}: {len(got)} bytes identical to the oracle")


def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return p.stdout.strip() or p.stderr.strip()


def phase0(n_gpus: int) -> dict:
    log("== phase 0: device")
    log(f"nvidia-smi: {card_name_and_power()}")
    probe = (
        "import json, jax\n"
        "from orion_kmer_tpu import backend\n"
        "from orion_kmer_tpu.ingest import native\n"
        "d = jax.devices()\n"
        "print(json.dumps({'platform': d[0].platform, 'kind': d[0].device_kind,"
        " 'count': len(d), 'backend': jax.default_backend(),"
        " 'jax': jax.__version__, 'native': native.available(),"
        " 'flush_windows': backend.flush_windows(),"
        " 'table_max': backend.device_table_max()}))\n"
    )
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_CHILD_ENV,
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise SmokeFailure(f"device probe failed:\n{p.stderr[-3000:]}")
    info = json.loads(p.stdout.strip().splitlines()[-1])
    log(f"jax {info['jax']}: backend {info['backend']}, {info['count']} x {info['kind']}")
    check(info["backend"] == "gpu" and info["platform"] == "gpu", "JAX runs on the GPU")
    check(info["count"] >= n_gpus, f"at least {n_gpus} GPU(s) visible")
    check(info["native"], "native ingest loaded")
    log(f"flush bound {info['flush_windows']} windows, device table {info['table_max']} keys")
    return info


def phase1(pool, seed: int, n_reads: int, flush_windows: int) -> dict:
    log(f"== phase 1: count ({n_reads} reads x {READ_LEN} bp)")
    if n_reads < FULL_READS:
        log(f"  cut: {n_reads} of {FULL_READS} reads (read length, error rate "
            "and genome unchanged)")
    g = genome(seed, 0)
    t0 = time.perf_counter()
    reads = DATA / "reads.fq.gz"
    write_reads(reads, g, seed, n_reads, gz=True)
    sl = DATA / "slice.fq.gz"
    write_reads(sl, g, seed, min(SLICE_READS, n_reads), gz=True)
    log(f"  data: {reads.stat().st_size / 1e6:.1f} MB gz in {time.perf_counter() - t0:.1f} s")
    windows = n_reads * (READ_LEN - 31 + 1)
    log(f"  {windows} k=31 windows = {windows / flush_windows:.2f} x the flush bound")

    out = {}
    wall = cli(["count", "-k", 31, "-m", 2, "--histogram", WORK / "k31.histo",
                "-i", reads, "-o", WORK / "k31.tsv"])
    log(f"  count -k 31 -m 2 --histogram: {wall:.2f} s wall "
        f"({n_reads * READ_LEN / wall / 1e6:.1f} Mbp/s)")
    out["count_k31_s"] = wall
    t0 = time.perf_counter()
    vals, counts = oracle_counts(g, seed, n_reads, 31, pool)
    log(f"  oracle: {vals.shape[0]} distinct k-mers in {time.perf_counter() - t0:.1f} s")
    same_bytes(WORK / "k31.histo", render_histogram(counts), "k=31 histogram")
    keep = counts >= 2
    same_bytes(WORK / "k31.tsv", render_counts(vals[keep], counts[keep], 31), "k=31 counts (-m 2)")
    n_slice = min(SLICE_READS, n_reads)
    for k in (21, 15):
        wall = cli(["count", "-k", k, "--histogram", WORK / f"k{k}.histo",
                    "-i", sl, "-o", WORK / f"k{k}.tsv"])
        log(f"  count -k {k} (slice): {wall:.2f} s wall")
        v, c = oracle_counts(g, seed, n_slice, k, pool)
        same_bytes(WORK / f"k{k}.histo", render_histogram(c), f"k={k} histogram")
        same_bytes(WORK / f"k{k}.tsv", render_counts(v, c, k), f"k={k} counts")
    return out


def _classify_oracle(input_vals, input_counts, db, db_path, input_path):
    refs = []
    union = db.get_all_kmers_unified()
    for name in sorted(db.references):
        ref = db.references[name]
        m = np.isin(ref, input_vals)
        n = int(m.sum())
        depth = int(input_counts[np.searchsorted(input_vals, ref[m])].sum())
        refs.append({
            "reference_name": name,
            "total_kmers_in_reference": int(ref.shape[0]),
            "input_kmers_hitting_reference": n,
            "sum_depth_of_matched_kmers_in_input": depth,
            "avg_depth_of_matched_kmers_in_input": depth / n if n else 0.0,
            "proportion_input_kmers_hitting_reference": n / input_vals.shape[0],
            "reference_breadth_of_coverage": n / ref.shape[0],
        })
    overall = np.isin(input_vals, union)
    om, od = int(overall.sum()), int(input_counts[overall].sum())
    return {
        "input_file_path": str(input_path),
        "total_unique_kmers_in_input": int(input_vals.shape[0]),
        "min_kmer_frequency_filter": 1,
        "databases_analyzed": [{
            "database_path": str(db_path),
            "database_kmer_size": db.k,
            "total_unique_kmers_in_db_across_references": int(union.shape[0]),
            "overall_input_kmers_matched_in_db": om,
            "overall_sum_depth_of_matched_kmers_in_input": od,
            "overall_avg_depth_of_matched_kmers_in_input": od / om if om else 0.0,
            "proportion_input_kmers_in_db_overall": om / input_vals.shape[0],
            "proportion_db_kmers_covered_overall": om / union.shape[0],
            "references": refs,
        }],
    }


def _classify_tsv(doc) -> bytes:
    lines = ["InputFile\tDatabase\tReference\tTotalKmersInReference\t"
             "InputKmersHittingReference\tSumDepthMatchedKmers\t"
             "AvgDepthMatchedKmers\tProportionInputKmersHittingReference\t"
             "ReferenceBreadthOfCoverage\n"]
    for d in doc["databases_analyzed"]:
        for r in d["references"]:
            lines.append("\t".join([
                doc["input_file_path"], d["database_path"], r["reference_name"],
                str(r["total_kmers_in_reference"]),
                str(r["input_kmers_hitting_reference"]),
                str(r["sum_depth_of_matched_kmers_in_input"]),
                f"{r['avg_depth_of_matched_kmers_in_input']:.4f}",
                f"{r['proportion_input_kmers_hitting_reference']:.4f}",
                f"{r['reference_breadth_of_coverage']:.4f}",
            ]) + "\n")
    return "".join(lines).encode()


def phase2(pool, seed: int, n_reads: int) -> None:
    log("== phase 2: database commands")
    from orion_kmer_tpu import codec
    from orion_kmer_tpu.db import KmerDb
    from orion_kmer_tpu.ops.hash import splitmix64_np
    from orion_kmer_tpu.ops.sketch import sketch_np

    g1 = genome(seed, 0)
    gs = {"g1.fa": g1, "g2.fa": mutate(g1, seed, 0.01), "g3.fa": genome(seed, 2)}
    paths = []
    for name, g in gs.items():
        (DATA / name).write_bytes(fasta_bytes(name, g))
        paths.append(DATA / name)
    db_path = WORK / "db.db"
    wall = cli(["build", "-k", 31, "-o", db_path, "-g", *paths])
    log(f"  build -k 31 (3 genomes): {wall:.2f} s wall")
    db = KmerDb.load(db_path)
    want = {name: genome_kmers(g, 31)[0] for name, g in gs.items()}
    check(db.k == 31 and sorted(db.references) == sorted(want), "db holds the 3 references at k=31")
    check(all(np.array_equal(db.references[n], want[n]) for n in want),
          "db k-mer sets equal np.unique of each genome")

    sl = DATA / "slice.fq.gz"
    n_slice = min(SLICE_READS, n_reads)
    union = db.get_all_kmers_unified()
    wall = cli(["query", "-d", db_path, "-r", sl, "-c", 1, "-o", WORK / "hits.txt"])
    log(f"  query -c 1: {wall:.2f} s wall")
    hits = []
    for i in range(-(-n_slice // CHUNK_READS)):
        n = min(CHUNK_READS, n_slice - i * CHUNK_READS)
        reads = read_chunk(g1, seed, i, n)
        per = READ_LEN - 31 + 1
        codes = np.concatenate([reads, np.full((n, 1), 255, np.uint8)], 1).reshape(-1)
        win = codec.extract_kmers_np(codes, 31).reshape(n, per)
        hit = np.isin(win, union).sum(axis=1) >= 1
        hits += [b"r%08d\n" % (i * CHUNK_READS + j) for j in np.flatnonzero(hit).tolist()]
    same_bytes(WORK / "hits.txt", b"".join(hits), "query hit list (np.isin)")

    wall = cli(["classify", "-i", sl, "-d", db_path, "-o", WORK / "classify.json",
                "--output-tsv", WORK / "classify.tsv"])
    log(f"  classify --output-tsv: {wall:.2f} s wall")
    iv, ic = oracle_counts(g1, seed, n_slice, 31, pool)
    want_cls = _classify_oracle(iv, ic, db, db_path, sl)
    check(json.loads((WORK / "classify.json").read_text()) == want_cls,
          "classify JSON equals the np.isin oracle (floats exactly equal)")
    same_bytes(WORK / "classify.tsv", _classify_tsv(want_cls), "classify TSV")

    wall = cli(["compare", "--db1", db_path, "--db2", db_path, "-o", WORK / "compare.json"])
    cmp_doc = json.loads((WORK / "compare.json").read_text())
    check(cmp_doc["jaccard_index"] == 1.0
          and cmp_doc["intersection_size"] == cmp_doc["union_size"] == union.shape[0],
          f"compare db with itself: Jaccard 1.0 over {union.shape[0]} k-mers ({wall:.2f} s)")

    sig = WORK / "sketch.sig"
    wall = cli(["sketch", "-k", 31, "--scaled", 1000, "-i", *paths, "-o", sig])
    log(f"  sketch --scaled 1000: {wall:.2f} s wall")
    doc = json.loads(sig.read_text())
    ok = True
    sk = {}
    for s, (name, g) in zip(doc["sketches"], gs.items()):
        v, c = genome_kmers(g, 31)
        h = sketch_np(v, 1000)
        hv = splitmix64_np(v)
        order = np.argsort(hv)
        kept = order[hv[order] < np.uint64((1 << 64) // 1000)]
        ok &= [int(x) for x in s["hashes"]] == h.tolist()
        ok &= s["abundances"] == c[kept].tolist()
        sk[s["name"]] = h
    check(ok, "sketch hashes and abundances equal ops.sketch.sketch_np")
    cli(["sketch-compare", "-s", sig, "-o", WORK / "sketch_compare.json"])
    pairs = json.loads((WORK / "sketch_compare.json").read_text())["pairs"]
    good = True
    for p in pairs:
        a, b = sk[p["a"]], sk[p["b"]]
        inter = np.intersect1d(a, b).shape[0]
        union_ab = a.shape[0] + b.shape[0] - inter
        good &= (p["intersection"], p["union"], p["jaccard"]) == (inter, union_ab, inter / union_ab)
    check(good and len(pairs) == 3, "sketch-compare pairs equal np.intersect1d")

    manifest = WORK / "manifest.json"
    manifest.write_text(json.dumps([{"sample": "slice", "files": [str(sl)]}]))
    wall = cli(["profile", "-k", 31, "--manifest", manifest, "-d", db_path,
                "--scaled", 1000, "-o", WORK / "profile.json"])
    log(f"  profile: {wall:.2f} s wall")
    prof = json.loads((WORK / "profile.json").read_text())["profiles"][0]
    check(prof["status"] == "ok" and prof["unique_kmers"] == iv.shape[0]
          and prof["total_kmers"] == int(ic.sum())
          and prof["databases_analyzed"] == want_cls["databases_analyzed"],
          "profile counts and classification equal the oracle")


def _strip_times(doc: dict) -> dict:
    doc = {k: v for k, v in doc.items() if k not in ("elapsed_seconds", "samples_per_hour")}
    doc["profiles"] = [{k: v for k, v in p.items() if k != "seconds"} for p in doc["profiles"]]
    return doc


def phase3() -> None:
    log("== phase 3: serve")
    sock = DATA / "serve.sock"
    sock.unlink(missing_ok=True)
    t0 = time.perf_counter()
    srv = subprocess.Popen(
        [sys.executable, "-m", "orion_kmer_tpu", "serve", "--socket", str(sock)],
        cwd=ROOT, env=_CHILD_ENV, stdout=subprocess.DEVNULL,
        stderr=open(DATA / "serve.log", "w"),
    )
    try:
        while not sock.exists():
            if srv.poll() is not None:
                tail = (DATA / "serve.log").read_text()[-3000:]
                raise SmokeFailure(f"serve exited {srv.returncode}:\n{tail}")
            if time.perf_counter() - t0 > 600:
                raise SmokeFailure("serve did not bind its socket within 600 s")
            time.sleep(0.2)
        log(f"  serve ready after {time.perf_counter() - t0:.2f} s")
        sl = DATA / "slice.fq.gz"
        via = ["--server", sock]
        t = cli([*via, "count", "-k", 15, "--histogram", WORK / "s_k15.histo",
                 "-i", sl, "-o", WORK / "s_k15.tsv"])
        log(f"  first request, count -k 15: {t:.2f} s")
        for i in (1, 2):
            t = cli([*via, "count", "-k", 21, "--histogram", WORK / f"s{i}_k21.histo",
                     "-i", sl, "-o", WORK / f"s{i}_k21.tsv"])
            log(f"  {'first' if i == 1 else 'later'} count -k 21 request: {t:.2f} s")
        t = cli([*via, "classify", "-i", sl, "-d", WORK / "db.db",
                 "-o", WORK / "s_classify.json", "--output-tsv", WORK / "s_classify.tsv"])
        log(f"  classify request: {t:.2f} s")
        t = cli([*via, "profile", "-k", 31, "--manifest", WORK / "manifest.json",
                 "-d", WORK / "db.db", "--scaled", 1000, "-o", WORK / "s_profile.json"])
        log(f"  profile request: {t:.2f} s")
        cli([*via, "shutdown"])
        srv.wait(timeout=60)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    for a, b in [("s_k15.tsv", "k15.tsv"), ("s_k15.histo", "k15.histo"),
                 ("s1_k21.tsv", "k21.tsv"), ("s2_k21.tsv", "k21.tsv"),
                 ("s2_k21.histo", "k21.histo"), ("s_classify.json", "classify.json"),
                 ("s_classify.tsv", "classify.tsv")]:
        check((WORK / a).read_bytes() == (WORK / b).read_bytes(),
              f"serve {a} identical to fresh-process {b}")
    p_srv = _strip_times(json.loads((WORK / "s_profile.json").read_text()))
    p_new = _strip_times(json.loads((WORK / "profile.json").read_text()))
    check(p_srv == p_new, "serve profile equal to fresh-process profile (wall-time fields aside)")


def sharded(pool, seed: int, n_reads: int) -> None:
    """Multi-species reads with Zipf abundance, counted on 4 GPUs and on
    one, against the oracle: k=31 on all reads, k=21 and 15 on the
    first chunk."""
    log(f"== sharded count on 4 GPUs ({n_reads} reads, 8 species, Zipf abundance)")
    species = [genome(seed, 10 + i, GENOME_LEN // 4) for i in range(8)]
    weight = 1.0 / np.arange(1, 9)
    copies = np.maximum(1, np.round(weight / weight[-1])).astype(int)
    # abundance ~ 1/rank: repeat each genome in the sampled source
    src = np.concatenate([np.concatenate([g] * c) for g, c in zip(species, copies)])
    reads = DATA / "meta.fq.gz"
    write_reads(reads, src, seed, n_reads, gz=True)
    sl = DATA / "meta_slice.fq.gz"
    n_slice = min(SLICE_READS, n_reads)
    write_reads(sl, src, seed, n_slice, gz=True)
    for k, path, n in ((31, reads, n_reads), (21, sl, n_slice), (15, sl, n_slice)):
        for shards in ("4", "0"):
            tag = f"k{k}_s{shards}"
            wall = cli(["count", "-k", k, "-m", 2, "--histogram", WORK / f"{tag}.histo",
                        "-i", path, "-o", WORK / f"{tag}.tsv"],
                       env={"ORION_KMER_SHARDS": shards})
            log(f"  count -k {k} ({n} reads) ORION_KMER_SHARDS={shards}: {wall:.2f} s wall")
        v, c = oracle_counts(src, seed, n, k, pool)
        keep = c >= 2
        same_bytes(WORK / f"k{k}_s4.tsv", render_counts(v[keep], c[keep], k), f"k={k} 4-GPU counts")
        same_bytes(WORK / f"k{k}_s4.histo", render_histogram(c), f"k={k} 4-GPU histogram")
        check((WORK / f"k{k}_s0.tsv").read_bytes() == (WORK / f"k{k}_s4.tsv").read_bytes()
              and (WORK / f"k{k}_s0.histo").read_bytes() == (WORK / f"k{k}_s4.histo").read_bytes(),
              f"k={k} 4-GPU output identical to the one-GPU output")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1)
    ap.add_argument("--reads", type=int, default=None,
                    help=f"reads to count (default {FULL_READS}; {SHARDED_READS} with --gpus 4)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # the parent runs only oracles: keep its own JAX (if any) off the card
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    try:
        import orion_kmer_tpu  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the orion_kmer_tpu package is not next to this script ({e})")
        return 2
    t_all = time.perf_counter()
    try:
        info = phase0(args.gpus)
        shutil.rmtree(DATA, ignore_errors=True)
        WORK.mkdir(parents=True)
        try:
            with ProcessPoolExecutor(min(16, os.cpu_count() or 1)) as pool:
                if args.gpus == 4:
                    sharded(pool, args.seed, args.reads or SHARDED_READS)
                else:
                    n_reads = args.reads or FULL_READS
                    phase1(pool, args.seed, n_reads, info["flush_windows"])
                    phase2(pool, args.seed, n_reads)
                    phase3()
        finally:
            shutil.rmtree(DATA, ignore_errors=True)
    except (SmokeFailure, subprocess.TimeoutExpired) as e:
        log(f"chip_smoke FAILED: {e}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    device = {key: info[key] for key in ("platform", "kind", "count")}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
