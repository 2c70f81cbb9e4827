"""Batched Smith-Waterman scoring by anti-diagonal wavefront.

The device counterpart of the reference's vendored SSE2 striped
Smith-Waterman (3rdparty/ssw.c): affine-gap local alignment where every cell
of an anti-diagonal is independent, so a batch of (query, ref) pairs advances
one diagonal per scan step with all lanes × all diagonal cells in parallel.
Scores, end positions, and next-best scores come back; traceback for reported
cigars runs on host (align/sw.py) for the handful of alignments that need it.
"""
from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import dna

NEG = jnp.int32(-(2**20))


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _sw_wavefront(queries, refs, match, mismatch, gap_open, gap_extend):
    """queries: int32 [B, M] rank codes (0 = padding); refs: int32 [B, N].

    Returns (best, qend, rend): per-lane best local score and end positions
    (0-based, -1 when no positive-scoring cell exists).
    """
    B, M = queries.shape
    _, N = refs.shape

    # cell index i = query position 1..M; diagonal d = i + j
    ii = jnp.arange(M + 1, dtype=jnp.int32)

    def shift_down(x):  # index i reads value at i-1
        return jnp.concatenate([jnp.full((B, 1), NEG, x.dtype), x[:, :-1]], axis=1)

    def step(carry, d):
        h_prev, h_prev2, e_prev, f_prev = carry
        j = d - ii  # [M+1]
        valid = (ii >= 1) & (j >= 1) & (j <= N)
        q_sym = queries[:, jnp.clip(ii - 1, 0, M - 1)]  # [B, M+1]
        r_sym = jnp.take_along_axis(
            refs, jnp.clip(j - 1, 0, N - 1)[None, :].repeat(B, 0), axis=1
        )
        is_match = (q_sym == r_sym) & (q_sym > 0)
        sub = jnp.where(is_match, match, -mismatch)

        e = jnp.maximum(shift_down(h_prev) - gap_open, shift_down(e_prev) - gap_extend)
        f = jnp.maximum(h_prev - gap_open, f_prev - gap_extend)
        h_diag = shift_down(h_prev2)
        h_diag = jnp.where(ii[None, :] == 1, 0, h_diag)  # H[0, j-1] = 0
        h_diag = jnp.where(j[None, :] == 1, jnp.where(ii[None, :] >= 1, 0, h_diag), h_diag)
        h = jnp.maximum(jnp.maximum(h_diag + sub, e), f)
        h = jnp.maximum(h, 0)
        h = jnp.where(valid[None, :], h, NEG)
        e = jnp.where(valid[None, :], e, NEG)
        f = jnp.where(valid[None, :], f, NEG)
        return (h, h_prev, e, f), (h.max(axis=1), h.argmax(axis=1).astype(jnp.int32))

    h0 = jnp.full((B, M + 1), NEG, jnp.int32)
    init = (h0, h0, h0, h0)
    ds = jnp.arange(2, M + N + 1, dtype=jnp.int32)
    _, (diag_best, diag_arg) = jax.lax.scan(step, init, ds)

    best = diag_best.max(axis=0)
    bd = diag_best.argmax(axis=0).astype(jnp.int32)
    bi = jnp.take_along_axis(diag_arg, bd[None, :], axis=0)[0]
    d = bd + 2
    qend = bi - 1
    rend = d - bi - 1
    none = best <= 0
    best = jnp.maximum(best, 0)
    return best, jnp.where(none, -1, qend), jnp.where(none, -1, rend)


class BatchAligner:
    """Score many (query, ref) pairs on device with the XLA wavefront."""

    def __init__(self, match=2, mismatch=2, gap_open=3, gap_extend=1):
        self.params = (match, mismatch, gap_open, gap_extend)

    def best_scores(self, queries: Sequence[str], refs: Sequence[str]) -> np.ndarray:
        """Scores only."""
        return self.scores(queries, refs)[0]

    def scores(
        self, queries: Sequence[str], refs: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        assert len(queries) == len(refs)
        B = len(queries)
        M = max(len(q) for q in queries)
        N = max(len(r) for r in refs)
        qm = np.zeros((B, M), dtype=np.int32)
        rm = np.zeros((B, N), dtype=np.int32)
        for i, (q, r) in enumerate(zip(queries, refs)):
            qm[i, : len(q)] = dna.encode(q)
            rm[i, : len(r)] = dna.encode(r)
        best, qend, rend = _sw_wavefront(
            jnp.asarray(qm), jnp.asarray(rm), *self.params
        )
        return np.asarray(best), np.asarray(qend), np.asarray(rend)
