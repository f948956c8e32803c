"""CPU oracle check of a count TSV (independent numpy path)."""

# runnable from the repo root (package not installed): put repo root on sys.path
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from orion_kmer_tpu import codec
from orion_kmer_tpu.ingest.fastx import parse_fastx_file

tsv, path, k = sys.argv[1], sys.argv[2], int(sys.argv[3])
vals_all = []
for rec in parse_fastx_file(path):
    codes = codec.seq_to_codes(rec.seq, normalize=True)
    vals_all.append(codec.extract_kmers_np(codes, k))
v, c = np.unique(np.concatenate(vals_all), return_counts=True)
# render expected TSV
exp_lines = []
for vv, cc in zip(v.tolist(), c.tolist()):
    seq = codec.u64_to_seq(vv, k)
    if isinstance(seq, bytes):
        seq = seq.decode()
    exp_lines.append(f"{seq}\t{cc}")
exp = "\n".join(exp_lines) + "\n"
got = open(tsv).read()
assert got == exp, f"MISMATCH: {len(got)} vs {len(exp)} bytes"
print(f"oracle OK: {tsv} byte-identical, {len(exp_lines)} k-mers", flush=True)
