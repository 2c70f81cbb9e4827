#!/usr/bin/env python3
"""Capacity-scale proof of the mesh-sharded index build.

Builds a >=40 Mchar index on the 8-virtual-device CPU mesh — each shard
(~5 Mchar) well past the toy test sizes — with the BWT/perm derived on-mesh
(distributed_bwt_perm: no host SA gather), asserts byte-equality against
the host builder, and measures:
  * dist_build_mchar_per_sec — mesh build throughput on the CPU mesh (a
    schedule-validity check, not a device number);
  * sharded vs replicated scan wall ratio on the same index (the psum-scan
    capacity-mode tax).

usage: dist_build_scale.py [MCHAR] [READLEN]
Prints one JSON line.
"""
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"  # an 8-virtual-device CPU mesh by design
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    mchar = float(sys.argv[1]) if len(sys.argv) > 1 else 40.0
    readlen = int(sys.argv[2]) if len(sys.argv) > 2 else 150
    n_reads = int(mchar * 1e6 / (readlen + 1))

    import jax
    from jax.sharding import Mesh

    from siga_tpu.index import sa as sa_mod
    from siga_tpu.parallel.dist_build import distributed_bwt_perm

    devs = jax.devices()
    assert len(devs) >= 8, f"need 8 virtual devices, got {len(devs)}"
    mesh = Mesh(np.array(devs), ("data",))

    rng = np.random.default_rng(11)
    gsize = int(mchar * 1e6 / 5)  # ~5x coverage
    genome = rng.integers(0, 4, gsize)
    A = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, gsize - readlen, n_reads)
    seqs = [A[genome[s : s + readlen]].tobytes().decode() for s in starts]
    codes, read_starts, _ = sa_mod.concat_reads(seqs)
    n = int(codes.size)

    t0 = time.time()
    bwt, perm = distributed_bwt_perm(codes, mesh)
    t_dist = time.time() - t0

    t0 = time.time()
    sa = sa_mod.suffix_array_host(codes)
    bwt_ref = sa_mod.bwt_from_sa(codes, sa)
    perm_ref = sa_mod.sai_perm_from_sa(sa, read_starts)
    t_host = time.time() - t0

    assert np.array_equal(bwt, bwt_ref), "BWT mismatch vs host builder"
    assert np.array_equal(perm, perm_ref), "perm mismatch vs host builder"

    # sharded vs replicated scan tax on a slice of the reads
    from siga_tpu.index.fm import FMIndex
    from siga_tpu.ops.fm_device import DeviceFM, DualScanner

    rcodes, _, _ = sa_mod.concat_reads([s[::-1] for s in seqs])
    rbwt, _rperm = distributed_bwt_perm(rcodes, mesh)
    fmi, rfmi = FMIndex(bwt, len(seqs)), FMIndex(rbwt, len(seqs))
    d1, d2 = DeviceFM(fmi), DeviceFM(rfmi)
    probe = seqs[:4096]
    maxlen = -(-readlen // 16) * 16

    def timed(scanner):
        h = scanner.dispatch(list(probe), 4096, maxlen, 45)
        scanner.collect(h)  # warm/compile
        t0 = time.time()
        h = scanner.dispatch(list(probe), 4096, maxlen, 45)
        out = scanner.collect(h)
        return time.time() - t0, out

    repl = DualScanner(d1, d2, pair_step=False)
    shard = DualScanner(d1, d2, mesh=mesh, shard_index=True)
    t_repl, a = timed(repl)
    t_shard, b = timed(shard)
    for va, vb in zip(a, b):
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    print(json.dumps({
        "metric": "dist_build_mchar_per_sec",
        "value": round(n / t_dist / 1e6, 3),
        "unit": "Mchar/s (8-virt-dev CPU mesh)",
        "detail": {
            "text_mchar": round(n / 1e6, 2),
            "shard_mchar": round(n / 8 / 1e6, 2),
            "dist_build_sec": round(t_dist, 1),
            "host_builder_sec": round(t_host, 1),
            "byte_equal": True,
            "scan_replicated_sec": round(t_repl, 3),
            "scan_sharded_sec": round(t_shard, 3),
            "sharded_scan_tax": round(t_shard / t_repl, 2),
        },
    }))


if __name__ == "__main__":
    main()
