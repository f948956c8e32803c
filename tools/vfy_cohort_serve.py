"""Config-4 cohort run through serve mode (VERDICT r4 item 4).

Run on the GPU host (this script orchestrates subprocesses, one at a
time, and never opens the device itself):

    python tools/vfy_cohort_serve.py [--samples 50] [--mbp-per-sample 1.0]

BASELINE.json config 4 is a multi-sample cohort profile (the reference
defines the cohort via find_hybrid_samples.py but has no multi-sample
driver).  This harness exercises it at ~50-sample scale AND measures the
reason serve mode exists: amortizing the per-process device start-up
and compiles across
many requests.

  1. Generates a synthetic cohort: 3 reference genomes (1 Mbp each), a
     multi-reference DB built from them, and N samples of 150 bp reads
     drawn from the references with mutations + random contamination.
     THREE samples are deliberately broken (missing file, truncated
     FASTQ, binary garbage) to demonstrate per-sample failure isolation
     at scale (profile must record them as "error" and keep going --
     the engine-side analog of find_hybrid_samples.py:71-83, 179-182).
  2. Builds the DB in a fresh process (timed: includes its own ladder).
  3. Runs `profile` in a FRESH process (timed: ladder + steady state).
  4. Starts ONE resident `serve` process, then forwards the SAME
     profile request twice (timed: req1 = first request with its
     compiles, req2 = warm steady state).
  5. Asserts the fresh and both serve outputs are identical modulo
     timing fields, n_error == 3, and prints one COHORT_RESULT JSON line
     with samples/hr for each mode and the serve-vs-fresh speedup.

"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = "/tmp/vfy_cohort"
K = 31
N_BROKEN = 3


def gen_fixtures(n_samples: int, mbp_per_sample: float) -> dict:
    os.makedirs(DIR, exist_ok=True)
    stamp = os.path.join(DIR, f"stamp_{n_samples}_{mbp_per_sample}")
    refs = [os.path.join(DIR, f"ref{c}.fasta") for c in "ABC"]
    manifest_path = os.path.join(DIR, "manifest.json")
    if os.path.exists(stamp):
        return {"refs": refs, "manifest": manifest_path}

    rng = np.random.default_rng(2024)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for path in refs:
        g = lut[rng.integers(0, 4, size=1_000_000)]
        genomes.append(g)
        with open(path, "wb") as f:
            f.write(b">" + os.path.basename(path).encode() + b"\n")
            f.write(g.tobytes() + b"\n")

    read_len = 150
    n_reads = int(mbp_per_sample * 1e6 / read_len)
    entries = []
    broken_idx = sorted({n_samples // 4, n_samples // 2, (3 * n_samples) // 4})
    assert len(broken_idx) == N_BROKEN
    for s in range(n_samples):
        name = f"S{s:03d}"
        path = os.path.join(DIR, f"{name}.fastq")
        entries.append({"sample": name, "files": [path]})
        if s in broken_idx:
            kind = broken_idx.index(s)  # one of each failure mode
            if kind == 0:
                # missing file: don't create it
                entries[-1]["files"] = [os.path.join(DIR, f"{name}_missing.fastq")]
            elif kind == 1:
                with open(path, "wb") as f:
                    f.write(b"@r0\nACGT\n+\n")  # truncated: quality line missing
            else:
                with open(path, "wb") as f:
                    f.write(rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes())
            continue
        # each sample: mostly one ref (mutated), some of a second, 20% random
        main_ref = genomes[s % 3]
        alt_ref = genomes[(s + 1) % 3]
        rows = []
        for i in range(n_reads):
            u = rng.random()
            if u < 0.6:
                p = int(rng.integers(0, main_ref.shape[0] - read_len))
                r = main_ref[p : p + read_len].copy()
                mut = rng.random(read_len) < 0.005
                r[mut] = lut[rng.integers(0, 4, size=int(mut.sum()))]
            elif u < 0.8:
                p = int(rng.integers(0, alt_ref.shape[0] - read_len))
                r = alt_ref[p : p + read_len].copy()
            else:
                r = lut[rng.integers(0, 4, size=read_len)]
            rows.append(b"@%s_r%d\n" % (name.encode(), i))
            rows.append(r.tobytes())
            rows.append(b"\n+\n" + b"I" * read_len + b"\n")
        with open(path, "wb") as f:
            f.write(b"".join(rows))
    with open(manifest_path, "w") as f:
        json.dump(entries, f)
    open(stamp, "w").close()
    print(f"fixtures: {n_samples} samples x {mbp_per_sample} Mbp, 3 refs", flush=True)
    return {"refs": refs, "manifest": manifest_path}


FORCE_CPU = False


def cli_env():
    env = dict(os.environ)
    if FORCE_CPU:
        env["JAX_PLATFORMS"] = "cpu"
        env["ORION_KMER_BATCH"] = str(1 << 20)
    return env


def run_fresh(argv, timeout=3600):
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "orion_kmer_tpu", *argv],
        cwd=REPO, env=cli_env(), timeout=timeout,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    dt = time.perf_counter() - t0
    if p.returncode != 0:
        sys.stderr.write(p.stderr.decode(errors="replace"))
        raise SystemExit(f"fresh run failed rc={p.returncode}: {argv[:2]}")
    return dt


def strip_timing(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    for key in ("elapsed_seconds", "samples_per_hour"):
        doc.pop(key, None)
    for prof in doc.get("profiles", []):
        prof.pop("seconds", None)
    return doc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--mbp-per-sample", type=float, default=1.0)
    ap.add_argument("--scaled", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true", help="dry-run the harness on CPU")
    args = ap.parse_args()
    global FORCE_CPU
    FORCE_CPU = args.cpu

    fx = gen_fixtures(args.samples, args.mbp_per_sample)
    db = os.path.join(DIR, "cohort.db")
    results = {"n_samples": args.samples, "mbp_per_sample": args.mbp_per_sample}

    # -- fresh-process DB build ------------------------------------------
    dt = run_fresh(["build", "-k", str(K), "-g", *fx["refs"], "-o", db])
    results["build_fresh_s"] = round(dt, 1)
    print(f"build (fresh): {dt:.1f} s", flush=True)

    prof_args = [
        "profile", "-k", str(K), "--manifest", fx["manifest"],
        "-d", db, "--scaled", str(args.scaled), "--min-coverage", "0.05",
    ]

    # -- fresh-process profile (pays the full ladder) --------------------
    out_fresh = os.path.join(DIR, "profile_fresh.json")
    dt = run_fresh([*prof_args, "-o", out_fresh], timeout=7200)
    results["profile_fresh_s"] = round(dt, 1)
    with open(out_fresh) as f:
        doc_fresh = json.load(f)
    print(
        f"profile (fresh): {dt:.1f} s wall, engine samples/hr "
        f"{doc_fresh['samples_per_hour']}, n_error={doc_fresh['n_error']}",
        flush=True,
    )

    # -- resident serve process ------------------------------------------
    sock = os.path.join(DIR, "okt.sock")
    if os.path.exists(sock):
        os.unlink(sock)  # a stale socket would fool the readiness probe
    srv = subprocess.Popen(
        [sys.executable, "-m", "orion_kmer_tpu", "serve", "--socket", sock],
        cwd=REPO, env=cli_env(),
        stdout=subprocess.DEVNULL, stderr=open(os.path.join(DIR, "serve.log"), "wb"),
    )
    try:
        import socket as socketlib

        t0 = time.perf_counter()
        while True:
            if srv.poll() is not None:
                raise SystemExit("serve process died at start-up (see serve.log)")
            if time.perf_counter() - t0 > 1800:
                raise SystemExit("serve did not come up in 30 min")
            if os.path.exists(sock):
                probe = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
                try:
                    probe.connect(sock)
                    probe.close()
                    break
                except OSError:
                    probe.close()
            time.sleep(1.0)
        results["serve_startup_s"] = round(time.perf_counter() - t0, 1)
        print(f"serve up after {results['serve_startup_s']} s", flush=True)

        docs = {}
        for req in (1, 2):
            out = os.path.join(DIR, f"profile_serve{req}.json")
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "orion_kmer_tpu", "--server", sock,
                 *prof_args, "-o", out],
                cwd=REPO, env=cli_env(), timeout=7200,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            dt = time.perf_counter() - t0
            if p.returncode != 0:
                sys.stderr.write(p.stderr.decode(errors="replace"))
                raise SystemExit(f"serve request {req} failed rc={p.returncode}")
            results[f"profile_serve{req}_s"] = round(dt, 1)
            with open(out) as f:
                docs[req] = json.load(f)
            print(
                f"profile (serve req{req}): {dt:.1f} s wall, engine samples/hr "
                f"{docs[req]['samples_per_hour']}",
                flush=True,
            )
    finally:
        subprocess.run(
            [sys.executable, "-m", "orion_kmer_tpu", "--server", sock, "shutdown"],
            cwd=REPO, env=cli_env(), timeout=120,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        try:
            srv.wait(timeout=120)
        except subprocess.TimeoutExpired:
            srv.kill()

    # -- checks ------------------------------------------------------------
    assert doc_fresh["n_error"] == N_BROKEN, doc_fresh["n_error"]
    base = strip_timing(doc_fresh)
    for req in (1, 2):
        assert strip_timing(docs[req]) == base, f"serve req{req} output differs"
    errs = [p["sample"] for p in doc_fresh["profiles"] if p["status"] == "error"]
    oks = [p for p in doc_fresh["profiles"] if p["status"] == "ok"]
    assert len(oks) == args.samples - N_BROKEN
    assert all(p["unique_kmers"] > 0 for p in oks)
    assert all(p.get("databases_analyzed") for p in oks)

    results["errors_isolated"] = errs
    results["samples_per_hour_fresh_wall"] = round(
        args.samples / results["profile_fresh_s"] * 3600, 1
    )
    results["samples_per_hour_serve_wall"] = round(
        args.samples / results["profile_serve2_s"] * 3600, 1
    )
    results["serve_speedup_vs_fresh"] = round(
        results["profile_fresh_s"] / results["profile_serve2_s"], 2
    )
    results["outputs_identical"] = True
    print("COHORT_RESULT " + json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
