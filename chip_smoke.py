#!/usr/bin/env python3
"""Run the assembler's main path on one GPU and check what it writes.

usage: python chip_smoke.py [--four] [--workdir DIR]

Every stage is a `./siga` subprocess, one after another, so that one JAX
process at a time holds the card.  This process never opens the device: the
stages report platform, device kind, count and peak device memory on stderr
(`[device] {...}`, siga_tpu/core/devstats.py) and the script reads those
lines.  Reads come from fixed seeds (benchmark/paired_read_gen.py).

Phases (default):
  device   a child process must see platform "gpu";
  parity   `siga index` (device) byte-equal to `siga index -a host` on
           >= 10 Mchar per orientation; on a few thousand reads,
           `siga overlap` (device engine) byte-equal to `--engine=host`, and
           `siga rmdup` byte-equal to its host path (engine=host through
           --ini, in a JAX_PLATFORMS=cpu child);
  pipeline the 1 Mb x 25x paired-end recipe of benchmark/ecoli_scale.py,
           whose contigs must match the recorded metrics.
With --four, only: `siga overlap` and `siga rmdup` on all visible cards
(four) byte-equal to the same commands on one card, with read lanes placed
on every card.

The last line of stdout is {"ok": true, "device": {...}}; any failed phase
exits non-zero without it, and leaves the work directory (default .smoke/)
with each stage's stderr under logs/.
"""
from __future__ import annotations

import argparse
import filecmp
import gzip
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.abspath(__file__))
SIGA = os.path.join(REPO, "siga")
BENCH = os.path.join(REPO, "benchmark")
STAGE_TIMEOUT = 1100  # seconds; a stage that hangs fails the run

# 1 Mb x 25x recipe: contigs_mapping.py metrics of the recorded runs
# (BASELINE.md, "Scale runs"); the pipeline is integer-only and these were
# bit-stable across every recorded run.
REFERENCE_METRICS = {
    "contig_number": "213",
    "matched_contig": "213",
    "unmatched_contig": "0",
    "N50": "8505",
    "N90": "2085",
    "MAX_contig": "39173",
}


class SmokeError(RuntimeError):
    pass


@dataclass(frozen=True)
class Sizes:
    genome_bp: int = 1_000_000  # recipe genome (ecoli_scale.py seeds)
    coverage: int = 25
    error: float = 0.005
    parity_coverage: int = 11  # ~11 Mchar per orientation on the genome
    parity_min_chars: int = 10_000_000
    subset_genome_bp: int = 20_000  # ~2,000 reads for the host oracle
    subset_coverage: int = 15
    four_coverage: int = 5  # ~33,000 reads sharded over the cards
    check_metrics: bool = True


@dataclass
class Stage:
    name: str
    seconds: float
    stderr: str
    devices: List[dict]

    def builder(self) -> Optional[str]:
        for line in self.stderr.splitlines():
            if line.startswith("[index] builder: "):
                return line.split("builder: ", 1)[1].split(",", 1)[0]
        return None


def _recipe():
    sys.path.insert(0, BENCH)
    import ecoli_scale

    return ecoli_scale


class Runner:
    """Runs `siga` stages in `workdir`, one process at a time."""

    def __init__(self, workdir: str, env: Optional[Dict[str, str]] = None):
        self.workdir = workdir
        self.env = dict(os.environ if env is None else env)
        self.stages: List[Stage] = []
        os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)

    def run(self, name: str, args: List[str], cwd: str = ".",
            env: Optional[Dict[str, str]] = None) -> Stage:
        e = dict(self.env)
        e.update(env or {})
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, SIGA] + args, cwd=os.path.join(self.workdir, cwd),
                env=e, capture_output=True, text=True, timeout=STAGE_TIMEOUT,
            )
        except subprocess.TimeoutExpired as exc:
            raise SmokeError(f"{name}: no end after {STAGE_TIMEOUT} s") from exc
        seconds = time.perf_counter() - t0
        with open(os.path.join(self.workdir, "logs", name + ".err"), "w") as f:
            f.write(proc.stderr)
        if proc.returncode != 0:
            raise SmokeError(
                f"{name}: `siga {' '.join(args)}` exited {proc.returncode}\n"
                + proc.stderr[-3000:]
            )
        stage = Stage(name, seconds, proc.stderr, _device_records(proc.stderr))
        self.stages.append(stage)
        return stage


def _device_records(stderr: str) -> List[dict]:
    prefix = "[device] "
    return [json.loads(line[len(prefix):]) for line in stderr.splitlines()
            if line.startswith(prefix)]


def _one_record(stage: Stage) -> dict:
    if len(stage.devices) != 1:
        raise SmokeError(f"{stage.name}: expected one [device] line, "
                         f"got {len(stage.devices)}")
    return stage.devices[0]


def card_line() -> str:
    """`name, power.limit` of each card, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError as exc:
        raise SmokeError("nvidia-smi not found: no NVIDIA GPU here") from exc
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return " | ".join(line.strip() for line in out.stdout.strip().splitlines())


def device_check(workdir: str, platform: str = "gpu",
                 env: Optional[Dict[str, str]] = None) -> dict:
    """Platform, kind and count as a child JAX process sees them."""
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=workdir,
                          env=dict(os.environ if env is None else env),
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SmokeError("device check failed:\n" + proc.stderr[-3000:])
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    if info["platform"] != platform:
        raise SmokeError(f"JAX platform is {info['platform']!r}, "
                         f"not {platform!r}")
    return info


def _count_reads(path: str) -> int:
    """Records in a FASTA or FASTQ file."""
    with open(path) as f:
        lines = f.read().splitlines()
    if lines and lines[0].startswith("@"):
        return len(lines) // 4
    return sum(1 for line in lines if line.startswith(">"))


def _same_files(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


def _same_gzip(a: str, b: str) -> bool:
    with gzip.open(a) as fa, gzip.open(b) as fb:
        return fa.read() == fb.read()


def make_reads(runner: Runner, subdir: str, genome_bp: int, genome_seed: int,
               coverage: int, error: float, read_seed: int) -> str:
    """Genome + 2x150 paired reads + `siga preprocess` in workdir/subdir;
    returns the preprocessed FASTQ's path relative to subdir."""
    es = _recipe()
    d = os.path.join(runner.workdir, subdir)
    os.makedirs(d, exist_ok=True)
    es.write_genome(os.path.join(d, "ref.fa"), genome_bp, seed=genome_seed)
    prefix = es.generate_reads("ref.fa", coverage, error, seed=read_seed, cwd=d)
    runner.run(f"{subdir}_preprocess",
               ["preprocess", "--pe-mode=1", "--pe-orientation=ff",
                "--no-primer-check", "-o", "reads.fastq",
                f"{prefix}_R1.fasta", f"{prefix}_R2.fasta"], cwd=subdir)
    return "reads.fastq"


def parity(runner: Runner, sizes: Sizes, platform: str = "gpu") -> dict:
    """Device vs host path, byte for byte: index, overlap, rmdup."""
    out = {}
    # --- index at >= parity_min_chars per orientation
    reads = make_reads(runner, "parity", sizes.genome_bp, 7,
                       sizes.parity_coverage, sizes.error, 2)
    dev = runner.run("parity_index_device",
                     ["index", "-p", "dev", reads], cwd="parity")
    host = runner.run("parity_index_host",
                      ["index", "-a", "host", "-p", "host", reads], cwd="parity")
    chars = int(dev.stderr.split("chars: ", 1)[1].split(",", 1)[0])
    if chars < sizes.parity_min_chars:
        raise SmokeError(f"parity index has {chars} chars, "
                         f"< {sizes.parity_min_chars}")
    if dev.builder() != "device" or host.builder() != "numpy":
        raise SmokeError(f"index builders: {dev.builder()} / {host.builder()}")
    rec = _one_record(dev)
    if rec["platform"] != platform:
        raise SmokeError(f"device index ran on {rec['platform']}")
    d = os.path.join(runner.workdir, "parity")
    for ext in (".bwt", ".sai", ".rbwt", ".rsai"):
        if not _same_files(os.path.join(d, "dev" + ext),
                           os.path.join(d, "host" + ext)):
            raise SmokeError(f"index {ext}: device differs from host")
    out["index"] = {"chars": chars, "equal": True,
                    "device_sec": dev.seconds, "host_sec": host.seconds,
                    "peak_bytes_in_use": rec["peak_bytes_in_use"]}

    # --- overlap and rmdup on a few thousand reads (host engine = oracle)
    reads = make_reads(runner, "subset", sizes.subset_genome_bp, 8,
                       sizes.subset_coverage, sizes.error, 3)
    runner.run("subset_index", ["index", "-p", "reads", reads], cwd="subset")
    d = os.path.join(runner.workdir, "subset")
    n_reads = _count_reads(os.path.join(d, reads))
    asqg = os.path.join(d, "reads.asqg.gz")
    ov_dev = runner.run("subset_overlap_device",
                        ["overlap", "-m", "45", "-p", "reads",
                         reads], cwd="subset")
    os.replace(asqg, os.path.join(d, "device.asqg.gz"))
    ov_host = runner.run("subset_overlap_host",
                         ["overlap", "-m", "45", "--engine=host", "-p", "reads",
                          reads], cwd="subset")
    if not _same_gzip(asqg, os.path.join(d, "device.asqg.gz")):
        raise SmokeError("overlap: device ASQG differs from host ASQG")
    n_edges = sum(1 for line in gzip.open(asqg, "rt") if line.startswith("ED"))
    if _one_record(ov_dev)["platform"] != platform:
        raise SmokeError("device overlap did not run on the device")
    out["overlap"] = {"reads": n_reads, "edges": n_edges, "equal": True,
                      "device_sec": ov_dev.seconds, "host_sec": ov_host.seconds}

    kept, dups = (os.path.join(d, "reads.rmdup" + x) for x in (".fa", ".dups.fa"))
    rm_dev = runner.run("subset_rmdup_device", ["rmdup", "-p", "reads", reads],
                        cwd="subset")
    os.replace(kept, os.path.join(d, "device.rmdup.fa"))
    os.replace(dups, os.path.join(d, "device.rmdup.dups.fa"))
    with open(os.path.join(d, "host.ini"), "w") as f:
        f.write("[rmdup]\nengine = host\n")
    rm_host = runner.run("subset_rmdup_host",
                         ["rmdup", "--ini", "host.ini", "-p", "reads", reads],
                         cwd="subset", env={"JAX_PLATFORMS": "cpu"})
    if rm_host.devices:
        raise SmokeError("host rmdup path used the device engine")
    for got, want in ((kept, "device.rmdup.fa"), (dups, "device.rmdup.dups.fa")):
        if not _same_files(got, os.path.join(d, want)):
            raise SmokeError(f"rmdup {want}: device differs from host")
    n_dups = sum(1 for line in open(dups) if line.startswith(">"))
    out["rmdup"] = {"reads": n_reads, "duplicates": n_dups, "equal": True,
                    "device_sec": rm_dev.seconds, "host_sec": rm_host.seconds}
    return out


def main_path(runner: Runner, sizes: Sizes, platform: str = "gpu") -> dict:
    """The reference recipe at 1 Mb x 25x through every stage."""
    es = _recipe()
    d = os.path.join(runner.workdir, "recipe")
    os.makedirs(d, exist_ok=True)
    es.write_genome(os.path.join(d, "ref.fa"), sizes.genome_bp)
    t0 = time.perf_counter()
    prefix = es.generate_reads("ref.fa", sizes.coverage, sizes.error, cwd=d)
    out = {"generate_sec": time.perf_counter() - t0, "stage_sec": {},
           "index_builder": {}, "peak_bytes_in_use": {}}
    native = None
    for name, args in es.pipeline(prefix):
        stage = runner.run(name, args, cwd="recipe")
        out["stage_sec"][name] = stage.seconds
        if args[0] == "index":
            out["index_builder"][name] = stage.builder()
        for rec in stage.devices:
            if rec["platform"] != platform:
                raise SmokeError(f"{name} ran on {rec['platform']}")
            out["peak_bytes_in_use"][name] = rec["peak_bytes_in_use"]
            native = rec["native"] if native is None else native and rec["native"]
        if name == "overlap":
            if not stage.devices:
                raise SmokeError("overlap reported no device")
    out["native_loaded"] = bool(native)
    if not native:
        raise SmokeError("the native C++ library was not loaded")
    out["total_sec"] = sum(out["stage_sec"].values())
    metrics = es.contig_metrics("ref.fa", "final-contigs.fa", cwd=d)
    out["contig_metrics"] = metrics
    if sizes.check_metrics:
        diff = {k: (metrics.get(k), v) for k, v in REFERENCE_METRICS.items()
                if metrics.get(k) != v}
        if diff:
            raise SmokeError(f"contig metrics differ (got, want): {diff}")
    elif metrics.get("unmatched_contig") != "0":
        raise SmokeError(f"unmatched contigs: {metrics}")
    return out


def four_cards(runner: Runner, sizes: Sizes, multi_env: Dict[str, str],
               single_env: Dict[str, str], count: int = 4,
               platform: str = "gpu") -> dict:
    """`siga overlap` and `siga rmdup` over `count` devices vs one."""
    reads = make_reads(runner, "four", sizes.genome_bp, 7,
                       sizes.four_coverage, sizes.error, 2)
    runner.run("four_index", ["index", "-p", "reads", reads], cwd="four",
               env=single_env)
    d = os.path.join(runner.workdir, "four")
    out = {}
    for cmd, args, outputs in (
        ("overlap", ["overlap", "-m", "85", "-p", "reads", reads],
         ["reads.asqg.gz"]),
        ("rmdup", ["rmdup", "-p", "reads", reads],
         ["reads.rmdup.fa", "reads.rmdup.dups.fa"]),
    ):
        one = runner.run(f"four_{cmd}_1", args, cwd="four", env=single_env)
        for name in outputs:
            os.replace(os.path.join(d, name), os.path.join(d, "one." + name))
        many = runner.run(f"four_{cmd}_{count}", args, cwd="four",
                          env=multi_env)
        r1, rn = _one_record(one), _one_record(many)
        if r1["count"] != 1 or rn["count"] != count:
            raise SmokeError(f"{cmd}: device counts {r1['count']}/{rn['count']}")
        if rn["lane_devices"] != list(range(count)):
            raise SmokeError(f"{cmd}: lanes on devices {rn['lane_devices']}")
        peaks = rn["peak_bytes_in_use"]
        if platform == "gpu" and not all(p and p > 0 for p in peaks):
            raise SmokeError(f"{cmd}: peak bytes per device {peaks}")
        for name in outputs:
            a, b = os.path.join(d, name), os.path.join(d, "one." + name)
            same = _same_gzip(a, b) if name.endswith(".gz") else _same_files(a, b)
            if not same:
                raise SmokeError(f"{cmd} {name}: {count} devices differ from 1")
        out[cmd] = {"equal": True, "lane_devices": rn["lane_devices"],
                    "peak_bytes_in_use": peaks, f"sec_{count}": many.seconds,
                    "sec_1": one.seconds}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the four-card overlap/rmdup comparison")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        shutil.rmtree(args.workdir, ignore_errors=True)
        os.makedirs(args.workdir)
        info = device_check(args.workdir)
        print(f"device: {json.dumps(info)}", flush=True)
        runner = Runner(args.workdir)
        sizes = Sizes()
        report = {"card": card}
        if args.four:
            if info["count"] != 4:
                raise SmokeError(f"--four needs 4 visible GPUs, {info['count']}")
            report["four"] = four_cards(runner, sizes, {},
                                        {"CUDA_VISIBLE_DEVICES": "0"})
            print(f"four: {json.dumps(report['four'])}", flush=True)
        else:
            if info["count"] != 1:
                raise SmokeError(f"needs 1 visible GPU, {info['count']} found")
            report["parity"] = parity(runner, sizes)
            print(f"parity: {json.dumps(report['parity'])}", flush=True)
            report["pipeline"] = main_path(runner, sizes)
            print(f"pipeline: {json.dumps(report['pipeline'])}", flush=True)
    except SmokeError as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    for stage in runner.stages:
        print(f"stage {stage.name}: {stage.seconds:.3f} s", flush=True)
    report["wall_sec"] = time.perf_counter() - t0
    print(f"summary: {json.dumps(report)}", flush=True)
    shutil.rmtree(args.workdir, ignore_errors=True)  # kept only on failure
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
