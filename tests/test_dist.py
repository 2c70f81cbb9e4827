"""Data-parallel overlap over a multi-device mesh (virtual 8-device CPU)."""
import random

import jax
import pytest

from siga_tpu.index import sa as sa_mod
from siga_tpu.index.fm import FMIndex
from siga_tpu.io.fastx import DNASeq
from siga_tpu.overlap.builder import Hit, OverlapBuilder
from siga_tpu.ops.search import batch_overlap_hits
from siga_tpu.parallel.dist import data_mesh


def test_mesh_overlap_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest forces an 8-device CPU mesh"
    rng = random.Random(9)
    genome = "".join(rng.choice("ACGT") for _ in range(500))
    seqs = [genome[i : i + 64] for i in range(0, 380, 12)]
    fwd, _p, ns = sa_mod.build_index_arrays(seqs)
    rev, _rp, _ = sa_mod.build_index_arrays([s[::-1] for s in seqs])
    fmi, rfmi = FMIndex(fwd, ns), FMIndex(rev, ns)
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]

    builder = OverlapBuilder(fmi, rfmi)
    host_lines = []
    for i, rec in enumerate(records):
        hit = Hit(idx=i)
        res = builder.overlap(rec.seq, 30, hit.blocks)
        hit.substring = res.substring
        host_lines.append(hit.serialize())

    mesh = data_mesh(8)
    dev_lines = [
        h.serialize()
        for h in batch_overlap_hits(builder, records, 30, mesh=mesh)
    ]
    assert dev_lines == host_lines


def test_sharded_fm_occ_matches_host():
    """SA-range-sharded occ queries (the live scan's sharded occ primitive,
    ops/fm_device.occ_all_fused_sharded_T) answer identically to the
    single-device host FM-index across shard boundaries."""
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from siga_tpu.ops.fm_device import DeviceFM, occ_all_fused_sharded_T

    rng = random.Random(3)
    genome = "".join(rng.choice("ACGT") for _ in range(600))
    seqs = [genome[i : i + 40] for i in range(0, 540, 13)]
    fwd, _p, ns = sa_mod.build_index_arrays(seqs)
    fmi = FMIndex(fwd, ns)
    dfm = DeviceFM(fmi)
    mesh = data_mesh(8)
    ndev = 8
    plane = dfm.occ_plane
    pad = (-int(plane.shape[0])) % ndev
    plane = jnp.pad(plane, ((0, pad), (0, 0)))
    plane = jax.device_put(plane, NamedSharding(mesh, P("data", None)))
    bps = int(plane.shape[0]) // ndev

    qs = np.array([-1, 0, 1, 37, 128, 129, 400, fmi.length - 1], dtype=np.int64)

    fn = jax.shard_map(
        lambda plane, i: occ_all_fused_sharded_T(
            plane, fmi.length, i, None, bps, "data"
        ),
        mesh=mesh,
        in_specs=(P("data", None), P()),
        out_specs=P(),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(plane, jnp.asarray(qs, jnp.int32))).T
    want = fmi.occ_all(qs)
    assert np.array_equal(got, want)


def test_index_sharded_scan_matches_replicated():
    """Stage-A scan against the SA-range-SHARDED occ plane (1/8 of the
    stacked fwd+rev plane per device, owner-answers + psum) produces hits
    byte-identical to the replicated-index scan and the exact host path,
    with the sharded FM wired into the overlap scan."""
    import numpy as np

    from siga_tpu.ops.fm_device import DeviceFM, DualScanner

    rng = random.Random(17)
    genome = "".join(rng.choice("ACGT") for _ in range(700))
    seqs = [genome[i : i + 56] for i in range(0, 560, 9)]
    fwd, _p, ns = sa_mod.build_index_arrays(seqs)
    rev, _rp, _ = sa_mod.build_index_arrays([s[::-1] for s in seqs])
    fmi, rfmi = FMIndex(fwd, ns), FMIndex(rev, ns)
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]

    mesh = data_mesh(8)
    dfwd, drev = DeviceFM(fmi), DeviceFM(rfmi)
    sharded = DualScanner(dfwd, drev, mesh, shard_index=True)
    # the plane really is partitioned: each device holds ~1/8 of the block
    # rows (row-major [rows, ncols] layout)
    shards = sharded.plane.addressable_shards
    assert len({s.device for s in shards}) == 8
    total_rows = sharded.plane.shape[0]
    assert all(s.data.shape[0] == total_rows // 8 for s in shards)

    n = -(-len(records) // 8) * 8  # lane bucket divisible by the mesh
    maxlen = 64
    h = sharded.dispatch([r.seq for r in records], n, maxlen, 25)
    f_view, r_view = sharded.collect(h)
    # route through the same block assembly as the production path
    repl = DualScanner(DeviceFM(fmi), DeviceFM(rfmi), mesh)
    h2 = repl.dispatch([r.seq for r in records], n, maxlen, 25)
    f2, r2 = repl.collect(h2)
    for a, b in zip(f_view, f2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(r_view, r2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
