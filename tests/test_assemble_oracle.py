"""Contig-level oracle tests.

Validates the real graph pipeline (overlap ASQG -> Bigraph load/EdgeCreator
-> merge algebra -> simplify -> contigs) against `tests/naive.py`'s
brute-force string-level contig walker, which never touches the production
machinery.  Reference semantics: /root/reference/src/assembler.cpp:95-241,
/root/reference/src/bigraph.cpp:341-414,626-677.
"""
import os
import random

from siga_tpu.commands import assemble_cmd, index_cmd, overlap_cmd
from siga_tpu.graph.bigraph import Bigraph
from siga_tpu.io import fastx

from naive import expected_irreducible_edges, naive_contigs, revcomp


def random_genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def write_fasta(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")


def mixed_strand_reads(genome, readlen, step, rng):
    """Tiled reads, every third one reverse-complemented (exercises the
    PP/SS orientation classes through the whole stack)."""
    reads = []
    k = 0
    for i in range(0, len(genome) - readlen + 1, step):
        s = genome[i : i + readlen]
        if k % 3 == 2:
            s = revcomp(s)
        reads.append((f"r{k:04d}", s))
        k += 1
    if (len(genome) - readlen) % step:
        reads.append((f"r{k:04d}", genome[-readlen:]))
    return reads


def canonical(contigs):
    return sorted(min(c, revcomp(c)) for c in contigs)


def read_contigs_fa(path):
    out = []
    for rec in fastx.read_sequences(path):
        out.append(rec.seq)
    return out


def test_assemble_command_matches_contig_oracle(tmp_path):
    """Clean linear genome, mixed strands: the full `siga assemble` schedule
    must produce exactly the oracle walker's contigs."""
    os.chdir(tmp_path)
    rng = random.Random(1234)
    genome = random_genome(rng, 1500)
    reads = mixed_strand_reads(genome, 100, 20, rng)
    named = dict(reads)
    assert len(set(named.values())) == len(named), "test wants distinct reads"

    oracle = naive_contigs(named, expected_irreducible_edges(named, 45))
    assert oracle == [min(genome, revcomp(genome))]

    write_fasta("reads.fa", reads)
    assert index_cmd.run({"prefix": "reads"}, ["reads.fa"]) == 0
    assert (
        overlap_cmd.run(
            {"prefix": "reads", "min-overlap": "45", "engine": "host"},
            ["reads.fa"],
        )
        == 0
    )
    assert (
        assemble_cmd.run(
            {"prefix": "out", "min-overlap": "45", "min-branch-length": "150"},
            ["reads.asqg.gz"],
        )
        == 0
    )
    got = canonical(read_contigs_fa("out-contigs.fa"))
    assert got == oracle


def test_simplify_matches_contig_oracle_branchy(tmp_path):
    """Genome with an exact interior repeat: spurious repeat overlaps create
    branch vertices; chain merging must stop exactly where the oracle stops.
    Compares ASQG-load + simplify (the assemble core) against the walker."""
    os.chdir(tmp_path)
    rng = random.Random(77)
    a = random_genome(rng, 520)
    rep = random_genome(rng, 64)
    b = random_genome(rng, 480)
    c = random_genome(rng, 500)
    genome = a + rep + b + rep + c
    reads = mixed_strand_reads(genome, 100, 16, rng)
    named = dict(reads)
    assert len(set(named.values())) == len(named)

    oracle = naive_contigs(named, expected_irreducible_edges(named, 45))

    write_fasta("reads.fa", reads)
    assert index_cmd.run({"prefix": "reads"}, ["reads.fa"]) == 0
    assert (
        overlap_cmd.run(
            {"prefix": "reads", "min-overlap": "45", "engine": "host"},
            ["reads.fa"],
        )
        == 0
    )
    with fastx.xopen("reads.asqg.gz", "rt") as stream:
        g = Bigraph.load(stream, 45, True, -1)
    g.validate()
    g.simplify()
    got = canonical(v.seq for v in g.vertices.values())
    assert got == oracle
