"""Decompose the pair-scan superstep at bench shapes + gather scaling.

Questions this answers:
 1. Does row-gather rate depend on TABLE SIZE (random-bandwidth bound)
    or only on row count (issue bound)?  -> 228B rows, 2/18/72MB tables.
 2. Is 456B (dual-row) gather the same issue cost as 228B?  -> W=114 vs 57.
 3. Where does the superstep's time go: gather / transpose / singles
    popcount / pairs popcount / update selects / emission?
All timed as 50-step lax.scan with data-dependent state (nothing hoists).
"""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from siga_tpu.ops.fm_device import (
    _pair_occ, _sel_rank, _below_rank, _tail_wmask,
)

STEPS = 50
Q = 50_000     # lanes (bench chunk: 12.5k reads x 4 orientation lanes)


def timeit(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(np.asarray(jax.tree.leaves(out)[0]))
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        out = fn(*args)
        np.asarray(jax.tree.leaves(out)[0])
        best = min(best, time.time() - t0)
    return best


@partial(jax.jit, static_argnums=(0, 1))
def gather_scan(steps, nrows, table, idx0):
    def step(idx, _):
        rows = table[idx]
        s = rows[:, :4].sum(axis=-1)
        return (idx + s) % nrows, ()

    out, _ = jax.lax.scan(step, idx0, None, length=steps)
    return out


@partial(jax.jit, static_argnums=(0, 1, 2))
def superstep_scan(variant, steps, nrows, table, pred, idx0):
    """variant: a=gather, b=+T, c=+singles, d=+pairs, e=+update, f=+emit."""
    Q2 = idx0.shape[0]
    Qh = Q2 // 2

    def step(carry, _):
        lo, hi = carry
        i = jnp.concatenate([lo, hi])
        pos = jnp.clip(i, 0, nrows * 128 - 1)
        block = pos // 128
        rows = table[jnp.clip(block, 0, nrows - 1)]
        if variant == "a":
            s = rows[:, :4].sum(axis=-1)
            nlo = (lo + s[:Qh]) % (nrows * 128)
            nhi = (hi + s[Qh:]) % (nrows * 128)
            return (nlo, nhi), ()
        rowsT = rows.T
        if variant == "b":
            s = rowsT[:4].sum(axis=0)
            nlo = (lo + s[:Qh]) % (nrows * 128)
            nhi = (hi + s[Qh:]) % (nrows * 128)
            return (nlo, nhi), ()
        tail = pos - block * 128
        c1 = (lo % 4 + 1).astype(jnp.int32)
        c1_2 = jnp.concatenate([c1, c1])
        want_pairs = variant not in ("c",)
        singles, pairs = _pair_occ(rowsT, block, tail, c1_2, want_pairs)
        if variant == "c":
            s = singles.sum(axis=0)
            nlo = (lo + s[:Qh]) % (nrows * 128)
            nhi = (hi + s[Qh:]) % (nrows * 128)
            return (nlo, nhi), ()
        if variant == "d":
            s = (singles.sum(axis=0) + pairs.sum(axis=0))
            nlo = (lo + s[:Qh]) % (nrows * 128)
            nhi = (hi + s[Qh:]) % (nrows * 128)
            return (nlo, nhi), ()
        # e/f: full update math
        c2 = (hi % 4 + 1).astype(jnp.int32)
        l_s, u_s = singles[:, :Qh], singles[:, Qh:]
        l_p, u_p = pairs[:, :Qh], pairs[:, Qh:]
        diff = u_s - l_s
        pd = u_p - l_p
        d1 = _sel_rank(diff, c1)
        nlo1 = _sel_rank(pred[:, None] + l_s, c1)
        nrlo1 = lo + _below_rank(diff, c1)
        nlo2 = _sel_rank(l_p, c2) + nlo1
        d2 = _sel_rank(pd, c2)
        nlo = jnp.abs(nlo2 + d1) % (nrows * 128)
        nhi = jnp.abs(nlo + d2 + nrlo1 % 7) % (nrows * 128)
        if variant == "e":
            return (nlo, nhi), ()
        emit0 = jnp.stack([lo, nlo1, d1], axis=0)
        emit1 = jnp.stack([nlo2, nrlo1, d2], axis=0)
        valid = jnp.stack([pd[0] > 0, diff[0] > 0], axis=0)
        return (nlo, nhi), (jnp.stack([emit0, emit1], axis=1), valid)

    out, ys = jax.lax.scan(step, (idx0[:Qh] * 128 % (nrows * 128),
                                  idx0[Qh:] * 128 % (nrows * 128)),
                           None, length=steps)
    if variant == "f":
        return out, jax.tree.map(lambda x: x.sum(), ys)
    return out


def main():
    rng = np.random.default_rng(0)
    print(f"platform: {jax.devices()[0].platform}", flush=True)

    # 1) table-size sweep at 228B rows
    for mb in (2, 18, 72):
        nrows = mb * 1024 * 1024 // 228
        table = jnp.asarray(rng.integers(0, 1000, (nrows, 57), dtype=np.int32))
        idx0 = jnp.asarray(rng.integers(0, nrows, 2 * Q, dtype=np.int32))
        dt = timeit(gather_scan, STEPS, nrows, table, idx0)
        rps = STEPS * 2 * Q / dt
        print(f"[size] {mb:3d}MB 57c: {dt*1e3:7.1f}ms {rps/1e9:.3f} Grows/s "
              f"{rps*228/1e9:6.1f} GB/s", flush=True)

    # 2) row width 114 (456B dual row) vs 57, same 36MB table
    for W in (57, 114):
        nrows = 36 * 1024 * 1024 // (4 * W)
        table = jnp.asarray(rng.integers(0, 1000, (nrows, W), dtype=np.int32))
        idx0 = jnp.asarray(rng.integers(0, nrows, 2 * Q, dtype=np.int32))
        dt = timeit(gather_scan, STEPS, nrows, table, idx0)
        rps = STEPS * 2 * Q / dt
        print(f"[width] {W}c ({W*4}B): {dt*1e3:7.1f}ms {rps/1e9:.3f} Grows/s",
              flush=True)
    # 2b) half the queries at 114c (the dual-row engine's actual shape)
    nrows = 36 * 1024 * 1024 // (4 * 114)
    table = jnp.asarray(rng.integers(0, 1000, (nrows, 114), dtype=np.int32))
    idx0 = jnp.asarray(rng.integers(0, nrows, Q, dtype=np.int32))
    dt = timeit(gather_scan, STEPS, nrows, table, idx0)
    print(f"[width] 114c halfQ: {dt*1e3:7.1f}ms "
          f"{STEPS*Q/dt/1e9:.3f} Grows/s", flush=True)

    # 3) superstep decomposition on an 18MB 57-col plane
    nrows = 18 * 1024 * 1024 // 228
    table = jnp.asarray(rng.integers(1, 1000, (nrows, 57), dtype=np.int32))
    pred = jnp.asarray(np.array([0, 10, 20, 30, 40], dtype=np.int32))
    idx0 = jnp.asarray(rng.integers(0, nrows, 2 * Q, dtype=np.int32))
    base = None
    for v in "abcdef":
        dt = timeit(superstep_scan, v, STEPS, nrows, table, pred, idx0)
        delta = "" if base is None else f" (+{(dt-base)*1e3:6.1f}ms)"
        if base is None:
            base = dt
        print(f"[part {v}] {dt*1e3:7.1f}ms{delta}", flush=True)


if __name__ == "__main__":
    main()
