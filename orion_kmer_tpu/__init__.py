"""orion-kmer-tpu: an exact k-mer engine on the GPU.

A from-scratch JAX/XLA re-design of the capabilities of the
``orion-kmer`` Rust CLI (github.com/motroy/orion-kmer).  The
compute path (k-mer extraction, canonicalization, counting, set algebra,
sketching) runs on the GPU via JAX; host-side ingest (FASTA/FASTQ parsing +
2-bit packing) runs in native C++ with a Python fallback.

Layer map (bottom-up; see SURVEY.md section 7):
  codec        -- host numpy codec, exact reference semantics (kmer.rs)
  ingest       -- FASTA/FASTQ tokenizer + gz/xz/zst IO (utils.rs, needletail)
  ops          -- device kernels: extraction, counting, set ops, sketching
  db           -- k-mer database model + bincode-compatible persistence
  engine       -- batched host<->device pipelines per command
  parallel     -- mesh / sharded multi-chip execution
  commands,cli -- the five subcommands with reference-parity outputs
  cohort       -- NCBI/SRA metadata tooling (find-hybrid, summarize, entrez)
"""

from .version import __version__

__all__ = ["__version__"]
