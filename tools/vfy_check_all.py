"""CPU oracle checks for the full verification matrix."""

# runnable from the repo root (package not installed): put repo root on sys.path
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import os

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from orion_kmer_tpu import codec
from orion_kmer_tpu.ingest.fastx import parse_fastx_file


def file_kmers(path, k, normalize=True):
    vals = []
    for rec in parse_fastx_file(path):
        codes = codec.seq_to_codes(rec.seq, normalize=normalize)
        vals.append(codec.extract_kmers_np(codes, k))
    return np.concatenate(vals) if vals else np.empty(0, np.uint64)


def check_tsv(tsv, path, k):
    v, c = np.unique(file_kmers(path, k), return_counts=True)
    lines = []
    for vv, cc in zip(v.tolist(), c.tolist()):
        s = codec.u64_to_seq(vv, k)
        if isinstance(s, bytes):
            s = s.decode()
        lines.append(f"{s}\t{cc}")
    exp = "\n".join(lines) + "\n" if lines else ""
    got = open(tsv).read()
    assert got == exp, f"{tsv}: MISMATCH ({len(got)} vs {len(exp)} bytes)"
    print(f"OK {tsv}: byte-identical, {len(lines)} k-mers", flush=True)


check_tsv("/tmp/vfy/big31.tsv", "/tmp/vfy/big.fasta", 31)
check_tsv("/tmp/vfy/big21.tsv", "/tmp/vfy/big.fasta", 21)  # narrowed u48 path
check_tsv("/tmp/vfy/big15.tsv", "/tmp/vfy/big.fasta", 15)
check_tsv("/tmp/vfy/t32.tsv", "/tmp/vfy/tedge.fasta", 32)

# sketch: independent oracle via splitmix64 on unique canonical k-mers
from orion_kmer_tpu.ops.sketch import sketch_np

doc = json.load(open("/tmp/vfy/ab.sig"))
assert doc["k"] == 31 and doc["scaled"] == 100
for s, path in zip(doc["sketches"], ["/tmp/vfy/a.fasta", "/tmp/vfy/b.fasta"]):
    exp_h = sketch_np(file_kmers(path, 31), 100)
    got_h = np.array([int(x) for x in s["hashes"]], dtype=np.uint64)
    assert np.array_equal(np.sort(got_h), exp_h), f"sketch mismatch for {path}"
print(f"OK sketches: {[len(s['hashes']) for s in doc['sketches']]} hashes exact", flush=True)

# sketch-compare: pairwise path vs direct intersect1d
cmpdoc = json.load(open("/tmp/vfy/ab_cmp.json"))
a = np.array([int(x) for x in doc["sketches"][0]["hashes"]], dtype=np.uint64)
b = np.array([int(x) for x in doc["sketches"][1]["hashes"]], dtype=np.uint64)
inter = len(np.intersect1d(a, b))
union = len(a) + len(b) - inter
p = cmpdoc["pairs"][0]
assert p["intersection"] == inter and p["union"] == union, p
assert abs(p["jaccard"] - inter / union) < 1e-12
print(f"OK sketch-compare: inter={inter} union={union} j={p['jaccard']:.4f}", flush=True)

# compare self-join
self_cmp = json.load(open("/tmp/vfy/self.json"))
assert self_cmp["jaccard_index"] == 1.0, self_cmp
assert self_cmp["intersection_size"] == self_cmp["union_size"]
# cross-check union size vs oracle: union of unique k-mer sets of a+b
ua = np.unique(file_kmers("/tmp/vfy/a.fasta", 21))
ub = np.unique(file_kmers("/tmp/vfy/b.fasta", 21))
uni = np.union1d(ua, ub)
assert self_cmp["union_size"] == uni.shape[0], (self_cmp["union_size"], uni.shape[0])
print(f"OK compare: jaccard=1.0, union={uni.shape[0]} matches oracle", flush=True)

# query: reads with >= 1 matching window (multiplicity, raw bytes)
dbset = uni
hits_exp = []
for rec in parse_fastx_file("/tmp/vfy/reads.fastq"):
    if len(rec.seq) < 21:
        continue
    codes = codec.seq_to_codes(rec.seq, normalize=False)
    kv = codec.extract_kmers_np(codes, 21)
    n = np.isin(kv, dbset).sum()
    if n >= 1:
        hits_exp.append(rec.id.decode() if isinstance(rec.id, bytes) else rec.id)
got_hits = open("/tmp/vfy/hits.txt").read().splitlines()
assert got_hits == hits_exp, (len(got_hits), len(hits_exp))
print(f"OK query: {len(got_hits)} hit reads exact", flush=True)

# classify: per-reference breadth vs np.isin
cls = json.load(open("/tmp/vfy/cls.json"))
inp = file_kmers("/tmp/vfy/reads.fastq", 21)
iv, ic = np.unique(inp, return_counts=True)
for dbres in cls["databases_analyzed"]:
    for ref in dbres["references"]:
        name = ref["reference_name"]
        path = {"a.fasta": "/tmp/vfy/a.fasta", "b.fasta": "/tmp/vfy/b.fasta"}[name]
        rset = np.unique(file_kmers(path, 21))
        m = np.isin(iv, rset)
        matched = int(m.sum())
        breadth = matched / rset.shape[0]
        assert ref["input_kmers_hitting_reference"] == matched, (name, ref, matched)
        assert abs(ref["reference_breadth_of_coverage"] - breadth) < 1e-12, (name, ref, breadth)
print("OK classify: per-ref matched/breadth exact", flush=True)
print("ALL CHECKS PASSED", flush=True)
