"""Device-mesh data parallelism for the overlap engine.

The device counterpart of the reference's OpenMP read fan-out
(/root/reference/src/parallel_framework.h:16-59): read lanes are sharded
across a 1-D `data` mesh axis, the FM-index tables are replicated, and each
device runs the stage-A backward-search scan on its shard.  Per-device hit
buffers mirror the per-thread hits files (src/overlap_builder.cpp:444-457);
the host gathers them in deterministic device order.

For >HBM indexes, the plan (phase 2) is SA-range sharding of the occ/BWT
arrays with interval queries routed to the owning shard.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data mesh over this process's addressable devices.

    Local (not global) devices on purpose: in the multi-process regime
    (parallel/multihost.py) each process scans its own read slice against a
    replicated index and the shards merge through hit files — the
    reference's per-thread fan-out (src/overlap_builder.cpp:444-457) lifted
    to hosts — so device placement must stay addressable per process."""
    devices = jax.local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("data",))


def shard_lanes(mesh: Mesh, arr, axis: int = 0):
    """Place an array with lanes sharded over the data axis."""
    spec = [None] * arr.ndim
    spec[axis] = "data"
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))


def replicate(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths)
