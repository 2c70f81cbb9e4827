"""Per-step device cost via the slope method: run the scan R times
back-to-back (data-dependent chaining, one final sync) and difference, so
the fixed cost of dispatch and the host sync drops out."""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

STEPS = 50


@partial(jax.jit, static_argnums=(0, 1))
def chained(reps, variant, nrows, table, idx0):
    def one_scan(idx0):
        def step(idx, _):
            if variant == "nogather":
                return (idx * 1103515245 + 12345) % 999983, ()
            rows = table[idx]
            return (idx + rows[:, :4].sum()) % nrows, ()

        out, _ = jax.lax.scan(step, idx0, None, length=STEPS)
        return out

    idx = idx0
    for _ in range(reps):
        idx = one_scan(idx)
    return idx


def slope(variant, nrows, table, idx0):
    ts = {}
    for reps in (1, 9):
        out = chained(reps, variant, nrows, table, idx0)
        np.asarray(out)
        best = 1e9
        for _ in range(5):
            t0 = time.time()
            np.asarray(chained(reps, variant, nrows, table, idx0))
            best = min(best, time.time() - t0)
        ts[reps] = best
    per_exec = (ts[9] - ts[1]) / 8
    return per_exec, ts[1]


def main():
    rng = np.random.default_rng(0)
    print(f"platform: {jax.devices()[0].platform}", flush=True)
    nrows = 18 * 1024 * 1024 // 228
    table = jnp.asarray(rng.integers(0, 1000, (nrows, 57), dtype=np.int32))
    for Q in (25_000, 100_000, 400_000):
        idx0 = jnp.asarray(rng.integers(0, nrows, Q, dtype=np.int32))
        pe, t1 = slope("nogather", nrows, table, idx0)
        print(f"[nogather Q={Q:6d}] {pe/STEPS*1e6:8.1f} us/step (t1={t1*1e3:.1f}ms)",
              flush=True)
        pe, t1 = slope("gather", nrows, table, idx0)
        print(f"[gather   Q={Q:6d}] {pe/STEPS*1e6:8.1f} us/step "
              f"({STEPS*Q/pe/1e9:.3f} Grows/s, t1={t1*1e3:.1f}ms)", flush=True)


if __name__ == "__main__":
    main()
