"""Multi-process (multi-host analog) overlap: 2 JAX processes with a local
TCP coordinator, reads sharded round-robin, index replicated per process,
shards merged to an ASQG byte-identical to the single-process run
(BASELINE config 5)."""
import gzip
import os
import random
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_reads(tmp_path, n=120):
    rng = random.Random(5)
    genome = "".join(rng.choice("ACGT") for _ in range(900))
    seqs = [genome[i : i + 70] for i in range(0, 830, 7)][:n]
    path = os.path.join(tmp_path, "reads.fa")
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")
    return path


def test_two_process_overlap_matches_single(tmp_path):
    tmp = str(tmp_path)
    reads = _write_reads(tmp)
    prefix = os.path.join(tmp, "reads")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT

    def run(args, extra_env=None):
        e = dict(env)
        if extra_env:
            e.update(extra_env)
        r = subprocess.run(
            [sys.executable, "-m", "siga_tpu"] + args,
            env=e,
            cwd=tmp,
            capture_output=True,
            text=True,
        )
        assert r.returncode == 0, r.stderr[-2000:]

    run(["index", "-p", prefix, reads])

    # single-process run with 2 hit shards (the merge target layout)
    run(["overlap", "-m", "30", "-t", "2", "-p", prefix, reads])
    single = gzip.open(prefix + ".asqg.gz").read()
    for i in range(2):
        shutil.move(
            f"{prefix}-thread{i}.hits.gz", f"{prefix}-thread{i}.hits.single.gz"
        )
    os.remove(prefix + ".asqg.gz")

    # two workers with jax.distributed over a local coordinator
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"
    procs = []
    for pid in range(2):
        e = dict(env)
        e.update(
            SIGA_COORDINATOR=coord,
            SIGA_NUM_PROCESSES="2",
            SIGA_PROCESS_ID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "siga_tpu", "overlap", "-m", "30",
                    "-p", prefix, "--num-processes", "2",
                    "--process-id", str(pid), reads,
                ],
                env=e,
                cwd=tmp,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]

    # the per-process hit shards match the single-process shard files
    for i in range(2):
        got = gzip.open(f"{prefix}-thread{i}.hits.gz").read()
        want = gzip.open(f"{prefix}-thread{i}.hits.single.gz").read()
        assert got == want, f"shard {i} differs"

    # merge -> ASQG must be byte-identical to the single-process ASQG
    run(["overlap", "-m", "30", "-t", "2", "--merge-only", "-p", prefix, reads])
    merged = gzip.open(prefix + ".asqg.gz").read()
    assert merged == single


def test_worker_envs_give_each_worker_its_own_card():
    from siga_tpu.parallel.multihost import worker_envs

    envs = worker_envs(2, {"PATH": "/bin"}, gpus=["0", "1", "2", "3"])
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1"]
    assert all(e["PATH"] == "/bin" and "JAX_PLATFORMS" not in e for e in envs)
    # an explicit visible list is honoured and split the same way
    envs = worker_envs(2, {"CUDA_VISIBLE_DEVICES": "2,3"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["2", "3"]


def test_worker_envs_refuse_fewer_cards_than_workers():
    import pytest

    from siga_tpu.parallel.multihost import worker_envs

    with pytest.raises(RuntimeError, match="need one GPU each"):
        worker_envs(4, {}, gpus=["0", "1"])


def test_worker_envs_leave_cpu_workers_alone():
    from siga_tpu.parallel.multihost import visible_gpus, worker_envs

    envs = worker_envs(3, {"JAX_PLATFORMS": "cpu"}, gpus=["0"])
    assert all("CUDA_VISIBLE_DEVICES" not in e for e in envs)
    assert all(e["JAX_PLATFORMS"] == "cpu" for e in envs)
    assert visible_gpus({"CUDA_VISIBLE_DEVICES": ""}) == []
