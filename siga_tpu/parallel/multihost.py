"""Multi-host (multi-process) runtime for the pipeline stages.

The distribution model follows BASELINE config 5 and the reference's own
scaling philosophy lifted from threads to hosts: the FM-index is REPLICATED
per host, the read stream is SHARDED round-robin across processes, and each
process writes exactly the hits shard file a single-process
`siga overlap -t N` run would have written for its residue class
(/root/reference/src/overlap_builder.cpp:444-457 writes per-thread
`prefix-threadI.hits.gz`; here thread == process).  A final merge step
(rank 0, or any process after all shards exist) re-reads the shards and
emits the ASQG — byte-identical to the single-process `-t N` run, which the
2-process test asserts.

`jax.distributed` is initialized when coordination info is provided
(explicitly or via env), giving the processes a global barrier
(`sync_global_devices`) across hosts; on a shared filesystem the shard
files themselves are the hand-off, exactly like the reference's
file-staged pipeline (SURVEY §5.4).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Dict, List, Mapping, Optional


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or SIGA_* / JAX_* env vars.

    Returns True when a multi-process JAX runtime was set up."""
    import jax

    coordinator = coordinator or os.environ.get("SIGA_COORDINATOR")
    num_processes = num_processes or _env_int("SIGA_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("SIGA_PROCESS_ID")
    if not coordinator or num_processes is None or process_id is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def barrier(name: str = "siga") -> None:
    """Global barrier across processes (no-op in single-process runs)."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def visible_gpus(env: Mapping[str, str]) -> List[str]:
    """The GPU ids a process started with `env` may use: CUDA_VISIBLE_DEVICES
    when set, else every card nvidia-smi lists (none without nvidia-smi).
    Asks no JAX backend, so the caller reserves no device memory."""
    if "CUDA_VISIBLE_DEVICES" in env:
        return [c for c in env["CUDA_VISIBLE_DEVICES"].split(",") if c.strip()]
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    out = subprocess.run(
        [smi, "--query-gpu=index", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def worker_envs(
    num_processes: int, env: Mapping[str, str], gpus: Optional[List[str]] = None
) -> List[Dict[str, str]]:
    """One environment per worker process.  A JAX process reserves most of
    a card's memory when it first uses it, so on a GPU host worker `pid`
    sees only card `pid`; fewer cards than workers is an error.  The
    platform is left to JAX (JAX_PLATFORMS=cpu in `env` keeps workers off
    the cards)."""
    envs = [dict(env) for _ in range(num_processes)]
    if env.get("JAX_PLATFORMS") == "cpu":
        return envs
    gpus = visible_gpus(env) if gpus is None else gpus
    if not gpus:
        return envs
    if len(gpus) < num_processes:
        raise RuntimeError(
            f"{num_processes} worker processes need one GPU each; "
            f"{len(gpus)} visible ({','.join(gpus)})"
        )
    for pid, e in enumerate(envs):
        e["CUDA_VISIBLE_DEVICES"] = gpus[pid]
    return envs


def launch_overlap_2proc(
    input_path: str,
    prefix: str,
    min_overlap: int,
    num_processes: int = 2,
    coordinator_port: int = 0,
    extra_args: Optional[List[str]] = None,
) -> None:
    """Test/demo launcher: run `siga overlap` sharded over N local processes
    (each with jax.distributed initialized over a local TCP coordinator),
    then merge the shards in-process.  On a real deployment the same thing
    is N `siga overlap --process-id I --num-processes N` invocations (one
    per host, shared filesystem) followed by `siga overlap --merge-only`."""
    import socket

    if coordinator_port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coordinator_port = s.getsockname()[1]
        s.close()
    coordinator = f"127.0.0.1:{coordinator_port}"
    procs = []
    for pid, env in enumerate(worker_envs(num_processes, os.environ)):
        env["SIGA_COORDINATOR"] = coordinator
        env["SIGA_NUM_PROCESSES"] = str(num_processes)
        env["SIGA_PROCESS_ID"] = str(pid)
        cmd = [
            sys.executable,
            "-m",
            "siga_tpu",
            "overlap",
            "-m",
            str(min_overlap),
            "-p",
            prefix,
            "--num-processes",
            str(num_processes),
            "--process-id",
            str(pid),
        ] + (extra_args or []) + [input_path]
        procs.append(subprocess.Popen(cmd, env=env))
    for p in procs:
        rc = p.wait()
        assert rc == 0, f"worker exited {rc}"
    # merge (single process, no distributed init needed)
    from .. import cli

    rc = cli.main(
        [
            "overlap",
            "-m",
            str(min_overlap),
            "-p",
            prefix,
            "--merge-only",
            "-t",
            str(num_processes),
        ]
        + (extra_args or [])
        + [input_path]
    )
    assert rc in (0, None)
