#!/usr/bin/env python3
"""2-process scaling measurement for the multi-host overlap path
(BASELINE config 5 analog on one machine).

Runs `siga overlap` (1) single-process with -t 2 shards, then (2) as two
concurrent worker processes (--process-id 0/1) + merge, asserts the merged
ASQG is byte-identical to the single-process run, and reports
efficiency = t_single / (t_workers_wall + t_merge).

On a GPU host each worker gets its own card (parallel/multihost.py::
worker_envs), so it needs two; with JAX_PLATFORMS=cpu both workers share
the host's cores, and the efficiency mostly measures orchestration
overhead.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGA = os.path.join(REPO, "siga")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    env = dict(os.environ)
    td = tempfile.mkdtemp()
    os.chdir(td)
    sys.path.insert(0, REPO)
    from bench import simulate_reads
    from siga_tpu.parallel.multihost import worker_envs

    envs = worker_envs(2, env)

    seqs = simulate_reads(n, 100)
    with open("reads.fa", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")

    def sh(args):
        subprocess.run(args, check=True, env=env,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    sh([SIGA, "index", "-p", "reads", "reads.fa"])
    # warm caches/compiles
    sh([SIGA, "overlap", "-m", "45", "-t", "2", "-p", "reads", "reads.fa"])
    t0 = time.time()
    sh([SIGA, "overlap", "-m", "45", "-t", "2", "-p", "reads", "reads.fa"])
    t_single = time.time() - t0
    os.rename("reads.asqg.gz", "single.asqg.gz")

    t0 = time.time()
    procs = [
        subprocess.Popen(
            [SIGA, "overlap", "-m", "45", "-p", "reads",
             "--process-id", str(i), "--num-processes", "2", "reads.fa"],
            env=envs[i], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for i in range(2)
    ]
    for p in procs:
        assert p.wait() == 0
    t_workers = time.time() - t0
    t0 = time.time()
    sh([SIGA, "overlap", "-m", "45", "-p", "reads", "--merge-only", "-t", "2",
        "reads.fa"])
    t_merge = time.time() - t0

    import gzip

    same = gzip.open("single.asqg.gz").read() == gzip.open(
        "reads.asqg.gz"
    ).read()
    print(json.dumps({
        "reads": n,
        "t_single_t2_sec": round(t_single, 2),
        "t_workers_wall_sec": round(t_workers, 2),
        "t_merge_sec": round(t_merge, 2),
        "merged_equals_single": same,
        "efficiency_vs_single": round(t_single / (t_workers + t_merge), 3),
    }))
    assert same, "merged ASQG differs from single-process -t 2 run"


if __name__ == "__main__":
    main()
