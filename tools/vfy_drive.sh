set -x
cd "$(dirname "$0")/.."
# Drives every CLI subcommand over the tools/vfy_gen.py fixtures; the
# cmp of the two k=31 runs checks determinism.
T() { timeout 1800 "$@"; echo "rc=$?"; }
timeout 1800 python -m orion_kmer_tpu count -k 31 -i /tmp/vfy/big.fasta -o /tmp/vfy/big31.tsv; echo "rc=$?"
T python -m orion_kmer_tpu count -k 31 -i /tmp/vfy/big.fasta -o /tmp/vfy/big31b.tsv
cmp /tmp/vfy/big31.tsv /tmp/vfy/big31b.tsv && echo DETERMINISM-OK
T python -m orion_kmer_tpu count -k 31 -i /tmp/vfy/big.fasta.gz -o /tmp/vfy/big31gz.tsv
cmp /tmp/vfy/big31.tsv /tmp/vfy/big31gz.tsv && echo GZ-OK
T python -m orion_kmer_tpu count -k 21 -i /tmp/vfy/big.fasta -o /tmp/vfy/big21.tsv
T python -m orion_kmer_tpu count -k 15 -i /tmp/vfy/big.fasta -o /tmp/vfy/big15.tsv
T python -m orion_kmer_tpu count -k 32 -i /tmp/vfy/tedge.fasta -o /tmp/vfy/t32.tsv
cat /tmp/vfy/t32.tsv
T python -m orion_kmer_tpu sketch -k 31 -i /tmp/vfy/a.fasta /tmp/vfy/b.fasta --scaled 100 -o /tmp/vfy/ab.sig
T python -m orion_kmer_tpu sketch-compare -s /tmp/vfy/ab.sig -o /tmp/vfy/ab_cmp.json
T python -m orion_kmer_tpu build -k 21 -g /tmp/vfy/a.fasta /tmp/vfy/b.fasta -o /tmp/vfy/ab.db
T python -m orion_kmer_tpu compare --db1 /tmp/vfy/ab.db --db2 /tmp/vfy/ab.db -o /tmp/vfy/self.json
T python -m orion_kmer_tpu query -d /tmp/vfy/ab.db -r /tmp/vfy/reads.fastq -c 1 -o /tmp/vfy/hits.txt
T python -m orion_kmer_tpu classify -i /tmp/vfy/reads.fastq -d /tmp/vfy/ab.db -o /tmp/vfy/cls.json --output-tsv /tmp/vfy/cls.tsv
timeout 600 python -m orion_kmer_tpu count -k 33 -i /tmp/vfy/big.fasta -o /tmp/x.tsv; echo "k33 rc=$?"
timeout 600 python -m orion_kmer_tpu count -k 21 -i /tmp/vfy/nonexistent.fasta -o /tmp/x.tsv; echo "missing rc=$?"
echo ALL-DONE
