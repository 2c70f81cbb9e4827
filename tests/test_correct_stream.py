"""Streaming (bounded-memory) corrector vs the one-shot batch corrector:
identical output with small chunk sizes forcing many partial-table merges
(O(chunk) host memory, output identical)."""
import numpy as np
import pytest

from siga_tpu.correct.batch import (
    build_window_table_streaming,
    correct_reads_batch,
    correct_reads_streaming,
)
from siga_tpu.io.fastx import DNASeq


def _noisy_reads(n=1200, readlen=80, gsize=8000, seed=5):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, gsize)
    A = "ACGT"
    out = []
    for i in range(n):
        s = rng.integers(0, gsize - readlen)
        arr = genome[s : s + readlen].copy()
        for _ in range(rng.poisson(0.6)):
            arr[rng.integers(0, readlen)] = rng.integers(0, 4)
        out.append(DNASeq(name=f"r{i}", seq="".join(A[c] for c in arr)))
    return out


@pytest.mark.parametrize("chunk", [97, 500])
def test_streaming_matches_batch(chunk):
    reads = _noisy_reads()
    a = [(r.name, r.seq) for r in correct_reads_batch(reads, kmer_size=21)]
    b = [
        (r.name, r.seq)
        for r in correct_reads_streaming(
            reads, kmer_size=21, chunk_reads=chunk
        )
    ]
    assert a == b
    assert a  # some reads survive


def test_streaming_table_counts_match_oneshot():
    from siga_tpu.core import dna
    from siga_tpu.correct.batch import WindowCountTable

    reads = _noisy_reads(n=300, seed=9)
    k = 17
    lens = np.array([len(r.seq) for r in reads])
    L = int(lens.max())
    codes = np.zeros((len(reads), L), dtype=np.uint8)
    for i, r in enumerate(reads):
        codes[i, : lens[i]] = dna.encode(r.seq)
    one = WindowCountTable(codes, lens, k)
    stream = build_window_table_streaming(reads, k, chunk_reads=64)
    # spot-check every window of the first 50 reads
    for i in range(50):
        w = np.lib.stride_tricks.sliding_window_view(
            codes[i, : lens[i]], k
        )
        np.testing.assert_array_equal(
            one.lookup_windows(w), stream.lookup_windows(w)
        )
