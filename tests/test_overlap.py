import random

import numpy as np
import pytest

from siga_tpu.core import dna
from siga_tpu.index import sa as sa_mod
from siga_tpu.index.fm import FMIndex
from siga_tpu.overlap.builder import Hit, HitConverter, OverlapBuilder

from naive import expected_exhaustive_edges, revcomp


def build_indexes(seqs):
    fwd_codes, perm, ns = sa_mod.build_index_arrays(seqs)
    rev_codes, rperm, _ = sa_mod.build_index_arrays([s[::-1] for s in seqs])
    return FMIndex(fwd_codes, ns), FMIndex(rev_codes, ns), perm, rperm


def run_overlap(names, seqs, min_overlap, irreducible, rc=True, engine="host"):
    fmi, rfmi, perm, rperm = build_indexes(seqs)
    builder = OverlapBuilder(fmi, rfmi, irreducible=irreducible, rc=rc)
    conv = HitConverter(perm, rperm, names, [len(s) for s in seqs])
    edges = []
    hits = []
    if engine == "host":
        for i, s in enumerate(seqs):
            hit = Hit(idx=i)
            res = builder.overlap(s, min_overlap, hit.blocks)
            hit.substring = res.substring
            hits.append(hit)
    else:
        from siga_tpu.io.fastx import DNASeq
        from siga_tpu.ops.search import batch_overlap_hits

        records = [DNASeq(name=n, seq=s) for n, s in zip(names, seqs)]
        hits = list(batch_overlap_hits(builder, records, min_overlap))
    for hit in hits:
        ovls, _ = conv.convert(hit)
        edges.extend(str(o) for o in ovls)
    return sorted(edges), hits


def random_genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def tiled_reads(genome, readlen, step):
    reads = {}
    i = 0
    k = 0
    while i + readlen <= len(genome):
        reads[f"r{k:03d}"] = genome[i : i + readlen]
        i += step
        k += 1
    return reads


def test_exhaustive_matches_bruteforce():
    rng = random.Random(42)
    genome = random_genome(rng, 240)
    reads = tiled_reads(genome, 60, 17)
    names, seqs = list(reads), list(reads.values())
    got, hits = run_overlap(names, seqs, 25, irreducible=False)
    want = expected_exhaustive_edges(reads, 25)
    assert got == want
    assert not any(h.substring for h in hits)


def test_exhaustive_with_rc_reads():
    rng = random.Random(7)
    genome = random_genome(rng, 200)
    reads = tiled_reads(genome, 50, 23)
    # flip some reads to the reverse strand
    flipped = {}
    for i, (n, s) in enumerate(reads.items()):
        flipped[n] = revcomp(s) if i % 2 else s
    names, seqs = list(flipped), list(flipped.values())
    got, _ = run_overlap(names, seqs, 20, irreducible=False)
    want = expected_exhaustive_edges(flipped, 20)
    assert got == want


def test_no_rc_mode():
    rng = random.Random(3)
    genome = random_genome(rng, 150)
    reads = tiled_reads(genome, 50, 25)
    names, seqs = list(reads), list(reads.values())
    got, _ = run_overlap(names, seqs, 20, irreducible=False, rc=False)
    want = expected_exhaustive_edges(reads, 20, rc=False)
    assert got == want


def test_irreducible_chain():
    rng = random.Random(11)
    genome = random_genome(rng, 300)
    reads = tiled_reads(genome, 60, 20)
    names, seqs = list(reads), list(reads.values())
    got, _ = run_overlap(names, seqs, 25, irreducible=True)
    # only adjacent tiles overlap irreducibly (o=40); everything else is
    # transitive
    n = len(names)
    want = []
    for i in range(n - 1):
        q, t = names[i + 1], names[i]  # emitted from the lexicographically
        # greater query name
        lq = 60
        want.append(f"{q} {t} 0 39 60 20 59 60 0 0")
    assert got == sorted(want)


def test_substring_read_flagged():
    rng = random.Random(5)
    genome = random_genome(rng, 120)
    seqs = [genome[0:60], genome[40:100], genome[10:40]]  # third inside first
    names = ["a", "b", "c"]
    fmi, rfmi, perm, rperm = build_indexes(seqs)
    builder = OverlapBuilder(fmi, rfmi)
    hit = Hit(idx=2)
    res = builder.overlap(seqs[2], 20, hit.blocks)
    assert res.substring


def test_duplicate_reads_containment():
    seqs = ["ACGTACGTACGTACGTACGTTGCAACGT", "ACGTACGTACGTACGTACGTTGCAACGT"]
    names = ["x", "y"]
    got, hits = run_overlap(names, seqs, 10, irreducible=True)
    # duplicates: containment edge(s) with both coords full, emitted once from
    # the greater name with query not reversed
    assert any(" 0 27 28 0 27 28 " in e for e in got)
    assert not any(h.substring for h in hits)


def test_hit_serialization_roundtrip():
    rng = random.Random(13)
    genome = random_genome(rng, 200)
    reads = tiled_reads(genome, 50, 21)
    names, seqs = list(reads), list(reads.values())
    fmi, rfmi, perm, rperm = build_indexes(seqs)
    builder = OverlapBuilder(fmi, rfmi)
    for i, s in enumerate(seqs):
        hit = Hit(idx=i)
        res = builder.overlap(s, 20, hit.blocks)
        hit.substring = res.substring
        line = hit.serialize()
        assert line.endswith(" ")
        back = Hit.deserialize(line)
        assert back.serialize() == line


def test_device_stage_a_matches_host():
    rng = random.Random(17)
    genome = random_genome(rng, 260)
    reads = tiled_reads(genome, 55, 19)
    # add a reverse-strand read and a duplicate for coverage
    reads["rcx"] = revcomp(reads["r003"])
    names, seqs = list(reads), list(reads.values())
    host_edges, host_hits = run_overlap(names, seqs, 22, irreducible=True)
    dev_edges, dev_hits = run_overlap(
        names, seqs, 22, irreducible=True, engine="tpu"
    )
    assert [h.serialize() for h in dev_hits] == [h.serialize() for h in host_hits]
    assert dev_edges == host_edges


def test_device_stage_a_matches_host_exhaustive():
    rng = random.Random(19)
    genome = random_genome(rng, 180)
    reads = tiled_reads(genome, 45, 16)
    names, seqs = list(reads), list(reads.values())
    host_edges, host_hits = run_overlap(names, seqs, 18, irreducible=False)
    dev_edges, dev_hits = run_overlap(
        names, seqs, 18, irreducible=False, engine="tpu"
    )
    assert [h.serialize() for h in dev_hits] == [h.serialize() for h in host_hits]
    assert dev_edges == host_edges


def test_batched_rmdup_matches_host():
    from siga_tpu.io.fastx import DNASeq
    from siga_tpu.ops.search import batch_duplicate_hits

    rng = random.Random(23)
    genome = random_genome(rng, 300)
    seqs = [genome[i : i + 50] for i in range(0, 240, 17)]
    seqs.append(seqs[2])            # exact duplicate
    seqs.append(seqs[4][5:45])      # strict substring
    names = [f"r{i}" for i in range(len(seqs))]
    fmi, rfmi, _p, _rp = build_indexes(seqs)
    builder = OverlapBuilder(fmi, rfmi)

    host_lines = []
    for i, s in enumerate(seqs):
        hit = Hit(idx=i)
        res = builder.duplicate(s, hit.blocks)
        hit.substring = res.substring
        host_lines.append(hit.serialize())

    records = [DNASeq(name=n, seq=s) for n, s in zip(names, seqs)]
    dev_lines = [h.serialize() for h in batch_duplicate_hits(builder, records)]
    assert dev_lines == host_lines


def _dedup_reads(reads):
    """Drop exact duplicates and rc-duplicates (rmdup'd input assumption of
    the irreducible oracle)."""
    seen = set()
    out = {}
    for n, s in reads.items():
        if s in seen or revcomp(s) in seen:
            continue
        seen.add(s)
        out[n] = s
    return out


def test_irreducible_matches_bruteforce_oracle():
    """Default-mode (irreducible) ED output vs the string-level oracle —
    an executable reference-parity check that does not route through the
    FM-index machinery under test."""
    from naive import expected_irreducible_edges

    rng = random.Random(19)
    genome = random_genome(rng, 400)
    reads = _dedup_reads(tiled_reads(genome, 60, 9))
    names, seqs = list(reads), list(reads.values())
    got, hits = run_overlap(names, seqs, 30, irreducible=True)
    want = expected_irreducible_edges(reads, 30)
    assert got == want
    # and the device engine agrees with the host engine
    got_dev, _ = run_overlap(names, seqs, 30, irreducible=True, engine="tpu")
    assert got_dev == want


def test_irreducible_oracle_with_rc_reads():
    from naive import expected_irreducible_edges

    rng = random.Random(23)
    genome = random_genome(rng, 300)
    reads = _dedup_reads(tiled_reads(genome, 50, 11))
    flipped = {}
    for i, (n, s) in enumerate(reads.items()):
        flipped[n] = revcomp(s) if i % 3 == 1 else s
    names, seqs = list(flipped), list(flipped.values())
    got, _ = run_overlap(names, seqs, 25, irreducible=True)
    want = expected_irreducible_edges(flipped, 25)
    assert got == want


def test_irreducible_oracle_varied_lengths():
    from naive import expected_irreducible_edges

    rng = random.Random(31)
    genome = random_genome(rng, 350)
    reads = {}
    i = 0
    k = 0
    while i + 75 <= len(genome):
        L = [55, 65, 75][k % 3]
        reads[f"v{k:03d}"] = genome[i : i + L]
        i += 13
        k += 1
    reads = _dedup_reads(reads)
    names, seqs = list(reads), list(reads.values())
    got, _ = run_overlap(names, seqs, 28, irreducible=True)
    want = expected_irreducible_edges(reads, 28)
    assert got == want
