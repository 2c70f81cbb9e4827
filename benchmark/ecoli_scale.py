#!/usr/bin/env python3
"""E. coli-scale full-pipeline gate (BASELINE config 4).

Drives the reference recipe (examples/siga-ecoli-miseq.sh: correction k=41,
min overlap 85, assembly overlap 111, trim 150) over a simulated genome with
paired 2x150bp reads and substitution errors, then evaluates contigs with
contigs_mapping.py (contig_number / matched / N50 / N90 / MAX).  Real MiSeq
data is not downloaded: genome and reads come from fixed seeds.

usage: ecoli_scale.py [GENOME_MB] [COVERAGE] [ERR] [WORKDIR]
Prints one JSON line with per-stage wall seconds and contig metrics.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SIGA = os.path.join(REPO, "siga")

READLEN, INSERT, SIGMA = 150, 400, 20
GENOME_SEED, READ_SEED = 42, 1


def write_genome(path: str, n: int, seed: int = GENOME_SEED) -> None:
    """i.i.d. uniform ACGT genome of n bases, 80 columns per line."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
    genome = genome.tobytes().decode()
    with open(path, "w") as f:
        f.write(">ref\n")
        for i in range(0, n, 80):
            f.write(genome[i : i + 80] + "\n")


def generate_reads(ref: str, coverage: int, err: float, seed: int = READ_SEED,
                   readlen: int = READLEN, cwd: str = ".") -> str:
    """Paired reads from paired_read_gen.py; returns the R1/R2 file prefix."""
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "paired_read_gen.py"), ref,
         str(readlen), str(coverage), str(INSERT), str(SIGMA), str(seed),
         str(err)],
        check=True, capture_output=True, text=True, cwd=cwd,
    )
    return out.stdout.strip().splitlines()[-1]


def pipeline(prefix: str):
    """(stage name, siga arguments) in order.

    Stage layout follows the reference's own working benchmark pipeline
    (benchmark/paired_read_siga.sh:65-82 there; the shipped
    siga-ecoli-miseq.sh references a `filter.pass` file no stage produces),
    with the MiSeq recipe's parameters (examples/siga-ecoli-miseq.sh:23-37):
    pe-mode=1 primary assembly, then contig rmdup + re-overlap + final
    assembly."""
    return [
        ("preprocess", ["preprocess", "--pe-mode=1", "--pe-orientation=ff",
                        "--no-primer-check", "-o", "reads.pp.fastq",
                        f"{prefix}_R1.fasta", f"{prefix}_R2.fasta"]),
        ("index_pp", ["index", "--no-reverse", "-p", "reads.pp",
                      "reads.pp.fastq"]),
        ("correct", ["correct", "-k", "41", "-p", "reads.pp",
                     "-o", "reads.ec.fa", "reads.pp.fastq"]),
        ("index_ec", ["index", "-p", "reads.ec", "reads.ec.fa"]),
        ("overlap", ["overlap", "-m", "85", "--no-opposite-strand",
                     "-p", "reads.ec", "reads.ec.fa"]),
        ("assemble_pe", ["assemble", "-m", "111", "--pe-mode=1",
                         "--max-distance=100", "--min-branch-length", "150",
                         "-p", "primary", "reads.ec.asqg.gz"]),
        ("index_ctg", ["index", "-p", "primary-contigs", "primary-contigs.fa"]),
        ("rmdup", ["rmdup", "-p", "primary-contigs", "primary-contigs.fa"]),
        ("index_rmdup", ["index", "-p", "primary-contigs.rmdup",
                         "primary-contigs.rmdup.fa"]),
        ("overlap_ctg", ["overlap", "-m", "10", "--no-opposite-strand",
                         "-p", "primary-contigs.rmdup",
                         "primary-contigs.rmdup.fa"]),
        ("assemble_final", ["assemble", "-m", "111", "--pe-mode=0",
                            "--min-branch-length", "150", "-p", "final",
                            "primary-contigs.rmdup.asqg.gz"]),
    ]


def contig_metrics(ref: str, contigs: str, cwd: str = ".") -> dict:
    """contigs_mapping.py's report (min contig length 300) as a dict."""
    with open(os.path.join(cwd, contigs)) as f:
        stats = subprocess.run(
            [sys.executable, os.path.join(HERE, "contigs_mapping.py"),
             "300", ref, "fasta", "unmatched.fa"],
            stdin=f, check=True, capture_output=True, text=True, cwd=cwd,
        ).stdout
    metrics = {}
    for line in stats.strip().splitlines():
        if ":" in line:
            k, v = line.split(":", 1)
            metrics[k.strip()] = v.strip()
    return metrics


def main():
    genome_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 4.6
    coverage = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    err = float(sys.argv[3]) if len(sys.argv) > 3 else 0.005
    work = sys.argv[4] if len(sys.argv) > 4 else os.path.join(
        REPO, ".scale_test", f"ecoli_{genome_mb}_{coverage}_{err}"
    )
    os.makedirs(work, exist_ok=True)
    os.chdir(work)

    write_genome("ref.fa", int(genome_mb * 1e6))
    t = {}
    t0 = time.time()
    prefix = generate_reads("ref.fa", coverage, err)
    t["generate"] = time.time() - t0
    for name, args in pipeline(prefix):
        t0 = time.time()
        subprocess.run([SIGA] + args, check=True)
        t[name] = time.time() - t0

    n_reads = sum(1 for line in open("reads.ec.fa") if line.startswith(">"))
    result = {
        "genome_mb": genome_mb,
        "coverage": coverage,
        "error_rate": err,
        "n_reads_corrected": n_reads,
        "stage_sec": {k: round(v, 1) for k, v in t.items()},
        "total_pipeline_sec": round(sum(v for k, v in t.items()
                                        if k != "generate"), 1),
        "contig_metrics": contig_metrics("ref.fa", "final-contigs.fa"),
        "overlap_reads_per_sec": round(n_reads / t["overlap"], 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
