"""What would a device-side stage-B (irreducible wavefront extension) cost?

The native C++ stage B/C runs on the host beside the device scan.  A
device version would advance ALL
blocks of all reads one right-extension per lockstep step: per step per
block, 2 occ-plane row gathers (rlo-1, rhi on the reverse table) + 5-symbol
ext counts + per-read-group reductions (top-'$' emission / unique-symbol
continuation / split masks).

This probe measures that loop's device cost at engine shapes (slope
method): B blocks x E steps of gather + occ + a stand-in for the group
mask logic (segment reductions via per-read one-hot sums are approximated
with a segmented scan over sorted block order).
"""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from siga_tpu.ops.fm_device import _occ_from_rows

B = 98304    # blocks per 12.5k-read chunk (~8/read)
E = 40       # lockstep extension steps (survivors exit earlier in truth)
STEPS = E


@partial(jax.jit, static_argnums=(0, 1))
def wavefront(reps, nrows, plane, pred, rlo0, rhi0, read_of):
    sample = 128

    def one(carry):
        rlo, rhi, alive = carry

        def step(carry, _):
            rlo, rhi, alive = carry
            i = jnp.concatenate([rlo - 1, rhi])
            pos = jnp.clip(i + 1, 0, nrows * sample - 1)
            block = pos // sample
            rows = plane[block]
            counts = _occ_from_rows(
                rows, block, pos - block * sample, sample
            )  # [5, 2B]
            l_c, u_c = counts[:, :B], counts[:, B:]
            ext = u_c - l_c  # [5, B] per-block extension counts
            # group logic stand-in: per-read symbol totals via segment sums
            # (read_of is sorted; segment boundaries static) + the top-'$'
            # and unique-symbol masks
            seg = jnp.zeros((5, B), jnp.int32)
            # segmented inclusive scan approximated by a prefix-sum diff:
            csum = jnp.cumsum(ext, axis=1)
            seg = csum - jnp.take(
                jnp.pad(csum, ((0, 0), (1, 0))), read_of, axis=1
            )
            has_dollar = seg[0] > 0
            nz = (seg[1:] > 0).sum(axis=0)
            unique = nz == 1
            c = jnp.argmax(seg[1:], axis=0).astype(jnp.int32) + 1
            # updateR with chosen symbol (closed-form interval update)
            onec = jnp.take_along_axis(ext, c[None, :], axis=0)[0]
            below = jnp.where(
                jnp.arange(5)[:, None] < c[None, :], ext, 0
            ).sum(axis=0)
            nrlo = pred[c] + jnp.take_along_axis(l_c, c[None, :], axis=0)[0]
            nrhi = nrlo + onec - 1
            cont = alive & unique & ~has_dollar
            rlo = jnp.where(cont, nrlo + below % 3, rlo)
            rhi = jnp.where(cont, nrhi, rhi)
            alive = cont | (alive & has_dollar & (onec > 0))
            return (rlo, rhi, alive), ()

        out, _ = jax.lax.scan(step, (rlo, rhi, alive), None, length=STEPS)
        return out

    carry = (rlo0, rhi0, jnp.ones((B,), bool))
    for _ in range(reps):
        carry = one(carry)
    return carry[0]


def main():
    rng = np.random.default_rng(0)
    print(f"platform: {jax.devices()[0].platform}", flush=True)
    nrows = 79000  # bench-scale stacked plane rows
    plane = jnp.asarray(rng.integers(0, 1000, (nrows, 16), dtype=np.int32))
    pred = jnp.asarray(np.array([0, 10, 20, 30, 40], dtype=np.int32))
    n = nrows * 128
    rlo0 = jnp.asarray(rng.integers(1, n - 1, B, dtype=np.int32))
    rhi0 = jnp.asarray(np.minimum(np.asarray(rlo0) + 40, n - 2).astype(np.int32))
    # 8 blocks per read, sorted
    read_of = jnp.asarray((np.arange(B) // 8 * 8).astype(np.int32))

    ts = {}
    for reps in (1, 5):
        out = wavefront(reps, nrows, plane, pred, rlo0, rhi0, read_of)
        np.asarray(out)
        best = 1e9
        for _ in range(4):
            t0 = time.time()
            np.asarray(wavefront(reps, nrows, plane, pred, rlo0, rhi0, read_of))
            best = min(best, time.time() - t0)
        ts[reps] = best
    per_exec = (ts[5] - ts[1]) / 4
    print(f"wavefront {B} blocks x {E} steps: {per_exec*1e3:.1f} ms/exec "
          f"({per_exec/E*1e6:.0f} us/step; 4 such chunks => device version "
          f"~{4*per_exec*1e3:.0f} ms, to set beside native stage B/C's "
          f"stages_sec.native from bench.py)", flush=True)


if __name__ == "__main__":
    main()


@partial(jax.jit, static_argnums=(0, 1))
def wavefront_padded(reps, nrows, plane, pred, rlo0, rhi0):
    """Padded block-pool layout: [R reads x S slots] — per-read group
    reductions are plain sums over the slot axis (no segmented scans)."""
    sample = 128
    R, S = rlo0.shape

    def one(carry):
        rlo, rhi, alive = carry

        def step(carry, _):
            rlo, rhi, alive = carry  # [R, S]
            flat_lo = rlo.reshape(-1) - 1
            flat_hi = rhi.reshape(-1)
            i = jnp.concatenate([flat_lo, flat_hi])
            pos = jnp.clip(i + 1, 0, nrows * sample - 1)
            block = pos // sample
            rows = plane[block]
            counts = _occ_from_rows(rows, block, pos - block * sample, sample)
            Bf = R * S
            l_c = counts[:, :Bf].reshape(5, R, S)
            u_c = counts[:, Bf:].reshape(5, R, S)
            ext = jnp.where(alive[None], u_c - l_c, 0)  # [5, R, S]
            seg = ext.sum(axis=2)                        # [5, R] per-read
            has_dollar = seg[0] > 0
            nz = (seg[1:] > 0).sum(axis=0)
            unique = nz == 1
            c = jnp.argmax(seg[1:], axis=0).astype(jnp.int32) + 1  # [R]
            cS = c[:, None]
            onec = jnp.take_along_axis(
                ext.transpose(1, 2, 0), cS[:, :, None].repeat(S, 1), axis=2
            )[..., 0]
            lsel = jnp.take_along_axis(
                l_c.transpose(1, 2, 0), cS[:, :, None].repeat(S, 1), axis=2
            )[..., 0]
            nrlo = pred[c][:, None] + lsel
            nrhi = nrlo + onec - 1
            cont = alive & (unique & ~has_dollar)[:, None]
            rlo = jnp.where(cont, nrlo, rlo)
            rhi = jnp.where(cont, nrhi, rhi)
            alive = cont | (alive & (has_dollar[:, None] & (onec > 0)))
            return (rlo, rhi, alive), ()

        out, _ = jax.lax.scan(step, (rlo, rhi, alive), None, length=STEPS)
        return out

    carry = (rlo0, rhi0, jnp.ones(rlo0.shape, bool))
    for _ in range(reps):
        carry = one(carry)
    return carry[0]


def main_padded():
    rng = np.random.default_rng(0)
    nrows = 79000
    plane = jnp.asarray(rng.integers(0, 1000, (nrows, 16), dtype=np.int32))
    pred = jnp.asarray(np.array([0, 10, 20, 30, 40], dtype=np.int32))
    n = nrows * 128
    R, S = 12288, 8
    rlo0 = jnp.asarray(rng.integers(1, n - 1, (R, S), dtype=np.int32))
    rhi0 = jnp.asarray(
        np.minimum(np.asarray(rlo0) + 40, n - 2).astype(np.int32)
    )
    ts = {}
    for reps in (1, 5):
        out = wavefront_padded(reps, nrows, plane, pred, rlo0, rhi0)
        np.asarray(out)
        best = 1e9
        for _ in range(4):
            t0 = time.time()
            np.asarray(wavefront_padded(reps, nrows, plane, pred, rlo0, rhi0))
            best = min(best, time.time() - t0)
        ts[reps] = best
    per_exec = (ts[5] - ts[1]) / 4
    print(f"padded pool {R}x{S} x {E} steps: {per_exec*1e3:.1f} ms/exec "
          f"=> 4 chunks ~{4*per_exec*1e3:.0f} ms", flush=True)


if __name__ == "__main__" and "--padded" in sys.argv:
    main_padded()
