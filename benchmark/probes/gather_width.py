"""Probe: device row-gather cost vs row width, and device-to-host copy
bandwidth vs buffer size/content.

Informs the multi-symbol-step plane design: if gather cost is per row,
wider rows are nearly free and a pair/triple plane wins; if it is per byte,
the 228-byte pair row costs 3.6x the 64-byte single-step row.
"""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnums=(0,))
def gather_loop(steps, table, idx0):
    n = table.shape[0]

    def step(carry, _):
        idx = carry
        rows = table[idx]                       # [Q, W] row gather
        s = rows[:, :4].sum(axis=-1)
        return (idx + s) % n, ()

    out, _ = jax.lax.scan(step, idx0, None, length=steps)
    return out


def main():
    rng = np.random.default_rng(0)
    Q = 320000
    steps = 50
    nbytes = 2 * 1024 * 1024
    for W in (8, 16, 32, 64, 128):
        n = nbytes // (4 * W)
        table = jnp.asarray(rng.integers(0, 3, (n, W), dtype=np.int32))
        idx0 = jnp.asarray(rng.integers(0, n, Q, dtype=np.int32))
        r = gather_loop(steps, table, idx0)
        chk = int(np.asarray(r).sum())
        t0 = time.perf_counter()
        for _ in range(3):
            chk ^= int(np.asarray(gather_loop(steps, table, idx0)).sum())
        dt = (time.perf_counter() - t0) / 3
        rows_per_s = steps * Q / dt
        gbps = rows_per_s * W * 4 / 1e9
        print(f"W={W:4d} ({W*4:4d}B rows): {dt*1000:7.1f} ms  "
              f"{rows_per_s/1e9:.2f} Grows/s  {gbps:6.1f} GB/s chk={chk & 1}")

    # big-table variant (rows spread over 128MB, cache-hostile)
    for W in (16, 64):
        n = 128 * 1024 * 1024 // (4 * W)
        table = jnp.asarray(rng.integers(0, 3, (n, W), dtype=np.int32))
        idx0 = jnp.asarray(rng.integers(0, n, Q, dtype=np.int32))
        r = gather_loop(steps, table, idx0)
        chk = int(np.asarray(r).sum())
        t0 = time.perf_counter()
        for _ in range(3):
            chk ^= int(np.asarray(gather_loop(steps, table, idx0)).sum())
        dt = (time.perf_counter() - t0) / 3
        rows_per_s = steps * Q / dt
        print(f"big-table W={W:3d}: {dt*1000:7.1f} ms  "
              f"{rows_per_s/1e9:.2f} Grows/s  {rows_per_s*W*4/1e9:6.1f} GB/s"
              f" chk={chk & 1}")

    # device-to-host copies: big buffers, random (incompressible) vs zeros
    for mb, kind in ((64, "rand"), (64, "zero")):
        n = mb * 1024 * 1024 // 4
        h = (rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
             if kind == "rand" else np.zeros(n, dtype=np.int32))
        t0 = time.perf_counter()
        xd = jax.device_put(h)
        jax.block_until_ready(xd)
        up = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ = np.asarray(xd)
        down = time.perf_counter() - t0
        print(f"{mb} MB {kind}: up {mb/up:7.1f} MB/s  down {mb/down:7.1f} MB/s")


if __name__ == "__main__":
    main()
