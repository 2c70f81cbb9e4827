import random

import numpy as np
import pytest

from siga_tpu.align.sw import Aligner


def test_ssw_reference_fixture():
    """The reference SSW test (test/index_test.cpp:95-123)."""
    ref = "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA"
    query = "CTGAGCCGGTAAATC"
    a = Aligner(query).align(ref)
    assert a.ref_begin == 8
    assert a.ref_end == 21
    assert a.query_begin == 0
    assert a.query_end == 14
    assert a.cigar_string == "4=1X4=1I5="
    assert a.sw_score == 21


def test_exact_match():
    a = Aligner("ACGTACGT").align("TTTACGTACGTTTT")
    assert a.cigar_string == "8="
    assert a.sw_score == 16
    assert a.ref_begin == 3 and a.ref_end == 10


def test_softclip():
    # query head does not match anywhere: soft-clipped
    a = Aligner("GGGGACGTACGT").align("TTACGTACGTTT")
    assert a.cigar_string.endswith("8=")
    assert a.cigar_string.startswith("4S")


def naive_best_score(q, r, match=2, mis=2, go=3, ge=1):
    m, n = len(q), len(r)
    NEG = -(10**9)
    H = [[0] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i][j] = max(H[i - 1][j] - go, E[i - 1][j] - ge)
            F[i][j] = max(H[i][j - 1] - go, F[i][j - 1] - ge)
            s = match if q[i - 1] == r[j - 1] else -mis
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_scores_match_naive(seed):
    from siga_tpu.ops.sw_device import BatchAligner

    rng = random.Random(seed)
    queries, refs = [], []
    for _ in range(16):
        q = "".join(rng.choice("ACGT") for _ in range(rng.randint(8, 20)))
        r = "".join(rng.choice("ACGT") for _ in range(rng.randint(10, 40)))
        if rng.random() < 0.5:
            # embed a mutated copy of q into r for interesting alignments
            pos = rng.randint(0, len(r) - 1)
            mq = list(q)
            if len(mq) > 3:
                mq[rng.randint(0, len(mq) - 1)] = rng.choice("ACGT")
            r = r[:pos] + "".join(mq) + r[pos:]
        queries.append(q)
        refs.append(r)
    best, qend, rend = BatchAligner().scores(queries, refs)
    for q, r, b in zip(queries, refs, best):
        assert int(b) == naive_best_score(q, r), (q, r)


def test_device_end_positions():
    from siga_tpu.ops.sw_device import BatchAligner

    best, qend, rend = BatchAligner().scores(["ACGTACGT"], ["TTTACGTACGTTTT"])
    assert int(best[0]) == 16
    assert int(qend[0]) == 7
    assert int(rend[0]) == 10


def test_best_scores_xla_wavefront():
    # best_scores is the scores-only view of the XLA wavefront
    from siga_tpu.ops.sw_device import BatchAligner

    ba = BatchAligner()
    queries = ["ACGTACGT", "GGGGACGTACGT", "TTTT"]
    refs = ["TTTACGTACGTTTT", "TTACGTACGTTT", "ACGTACGA"]
    out = ba.best_scores(queries, refs)
    assert [int(x) for x in out] == [naive_best_score(q, r) for q, r in zip(queries, refs)]
    assert int(out[0]) == 16
