#!/usr/bin/env python3
"""Benchmark: overlap-detection reads/sec on a simulated read set.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

The primary metric (BASELINE.md) is overlap-detection reads/sec/chip, measured
three ways so the number is honest:
  * engine        — batch_overlap_hits: device stage A + native stage B/C,
                    warm (the compiled shapes are reused), hits not serialized;
  * end_to_end    — the full `siga overlap` command: FM-index load, engine,
                    .hits.gz write, VT/ED ASQG emission;
  * index_build   — fwd+rev device index build (one batched program), warm.

The baseline estimate for the reference on a 32-core CPU comes from the
throughput of SGA-family FM-index overlap on short reads (~2-4k reads/s/core
at 100bp, minOverlap~45; the reference publishes no numbers, its
docs/index.md:136-139 says "Comming soon"), i.e. ~100k reads/s at 32 cores.
vs_baseline is engine/(that estimate), a guess and not a speed claim.

Roofline context: the stage-A scan is random-gather bound, not FLOP bound —
each pair step gathers two 228-byte occ-plane rows per lane (4 orientation
lanes/read).  occ_gather_gbps is the gathered bytes over the scan time, and
hbm_frac divides it by the device memory bandwidth of PEAK_HBM_GBPS.

Device numbers only: a run whose JAX platform is the CPU stops with an
error, and so does a device missing from PEAK_HBM_GBPS.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_READS_PER_SEC = 100_000.0  # est. reference @ 32-core CPU (see above)

# Device memory bandwidth by jax device_kind, GB/s (NVIDIA H100 data sheet,
# SXM part: 3.35 TB/s).
PEAK_HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def _device():
    """(platform, device_kind) of the first device; a CPU run is refused."""
    import jax

    d = jax.devices()[0]
    if d.platform == "cpu":
        raise SystemExit("bench.py reports device numbers; JAX found no accelerator")
    if d.device_kind not in PEAK_HBM_GBPS:
        raise SystemExit(f"no memory bandwidth on record for {d.device_kind!r}")
    return d.platform, d.device_kind


def simulate_reads(num_reads=10_000, readlen=100, genome_size=None, seed=7):
    if genome_size is None:
        genome_size = 20 * num_reads  # constant 5x coverage at 100bp
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_size, dtype=np.int8)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, genome_size - readlen, num_reads)
    return [
        alphabet[genome[s : s + readlen]].tobytes().decode() for s in starts
    ]


def _stage_breakdown(builder, records, min_overlap):
    """Per-stage engine timing with hard device syncs between phases
    to localize where the time goes.

    Stages: pack (host 2-bit packing + upload), scan (device stage-A alone,
    block_until_ready), ship (pack+host copy of the compacted outputs), prep
    (host searchsorted/probe plumbing), native (C++ stage B/C).  The
    decomposed pass serializes device/host work, so the stage sum exceeds
    the pipelined engine_sec — the deltas are what matters.
    """
    import jax

    from siga_tpu.index import fm as fm_mod
    from siga_tpu.ops import search as search_mod
    from siga_tpu.ops.fm_device import (
        GROUP_COMP, GROUP_ID, GROUP_RC, GROUP_REV, DeviceFM, DualScanner,
        pack_reads_2bit,
    )
    from siga_tpu.ops.search import (
        _bucket_len, _bucket_reads, _final8_from_cands,
        _native_chunk_processor,
    )

    fmi, rfmi = builder.fmi, builder.rfmi
    scanner = DualScanner(
        DeviceFM(fmi), DeviceFM(rfmi), None,
        (GROUP_ID, GROUP_RC), (GROUP_REV, GROUP_COMP),
    )
    chunk_reads = search_mod.chunk_size(len(records))
    starts = list(range(0, len(records), chunk_reads))
    proc = _native_chunk_processor(builder)
    tm = {"pack": 0.0, "scan": 0.0, "ship": 0.0, "prep": 0.0, "native": 0.0}

    def run_pass(tm):
        for start in starts:
            chunk = records[start : start + chunk_reads]
            sqs = [r.seq for r in chunk]
            maxlen = _bucket_len(max(len(s) for s in sqs))
            n_bucket = _bucket_reads(len(chunk), chunk_reads, 1)

            t0 = time.time()
            la_w, lens = pack_reads_2bit(sqs, n_bucket, maxlen)
            la_d, lens_d = scanner._put(la_w, lens)
            jax.block_until_ready(la_d)
            tm["pack"] += time.time() - t0

            from siga_tpu.ops.fm_device import _granule

            max_t = maxlen - 1
            lim_t = min(max_t, -(-(int(lens.max()) - 1) // 8) * 8)
            num_lanes = n_bucket * 4
            cap, fcap = scanner._cap, num_lanes
            if scanner._kb == 0:
                scanner._kb = _granule(6 * n_bucket, 8192)
            if scanner._kc == 0:
                scanner._kc = _granule(2 * n_bucket + n_bucket // 8, 4096)
            kb, kc = min(scanner._kb, cap), min(scanner._kc, fcap)

            t0 = time.time()
            out = scanner._run(cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d)
            jax.block_until_ready(out)
            tm["scan"] += time.time() - t0

            t0 = time.time()
            packed_d = scanner._pack_ship(out, kb, kc)
            handle = (out, packed_d, kb, kc, cap, fcap, n_bucket, max_t,
                      lim_t, min_overlap, la_d, lens_d, False)
            f_view, r_view = scanner.collect(handle)
            tm["ship"] += time.time() - t0

            t0 = time.time()
            f_lane, f_t, f_data, f_cl, f_cr, f_sub = f_view
            r_lane, r_t, r_data, r_cl, r_cr, r_sub = r_view
            nb = len(f_sub) // 2
            num_lanes2 = 2 * nb
            lens_chunk = np.array([len(r.seq) for r in chunk], dtype=np.int64)
            f_starts = np.searchsorted(f_lane, np.arange(num_lanes2 + 1))
            r_starts = np.searchsorted(r_lane, np.arange(num_lanes2 + 1))
            f_fi = _final8_from_cands(num_lanes2, f_cl, f_cr)
            r_fi = _final8_from_cands(num_lanes2, r_cl, r_cr)
            tm["prep"] += time.time() - t0

            if proc is not None:
                t0 = time.time()
                proc.run(
                    lens_chunk, True, True, nb,
                    (f_starts, f_t, f_data, f_fi, f_sub),
                    (r_starts, r_t, r_data, r_fi, r_sub),
                )
                tm["native"] += time.time() - t0
        return tm

    run_pass(dict(tm))  # warm pass: sticky caps + compiles settle
    t_all = time.time()
    tm = run_pass(tm)
    tm["total_serialized"] = time.time() - t_all
    return {k: round(v, 3) for k, v in tm.items()}


def main():
    platform, kind = _device()
    # 50k reads: 5x coverage of a 1Mb genome
    num_reads = int(os.environ.get("BENCH_READS", "50000"))
    readlen = int(os.environ.get("BENCH_READLEN", "100"))
    min_overlap = int(os.environ.get("BENCH_MIN_OVERLAP", "45"))

    from siga_tpu.index import sa as sa_mod
    from siga_tpu.index.fm import FMIndex
    from siga_tpu.io.fastx import DNASeq
    from siga_tpu.overlap.builder import OverlapBuilder
    from siga_tpu.ops.search import batch_overlap_hits

    seqs = simulate_reads(num_reads, readlen)

    # pay backend init before timing
    import jax.numpy as jnp

    _ = int(jnp.zeros((8,)).sum())

    # index build: first run may compile (persistent cache), second is warm
    t0 = time.time()
    out = sa_mod.build_index_arrays_pair(seqs, use_device=True)
    index_cold = time.time() - t0
    t0 = time.time()
    fwd_codes, _perm, rev_codes, _rperm, ns = sa_mod.build_index_arrays_pair(
        seqs, use_device=True
    )
    index_warm = time.time() - t0
    del out

    fmi = FMIndex(fwd_codes, ns)
    rfmi = FMIndex(rev_codes, ns)
    builder = OverlapBuilder(fmi, rfmi)
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]

    # warmup (compile) over the full set: the timed pass then reuses every
    # compiled shape (chunk tails produce different block-count slice shapes)
    for _hit in batch_overlap_hits(builder, records, min_overlap):
        pass

    # best of 3 warm passes
    engine_sec = float("inf")
    for _rep in range(3):
        t0 = time.time()
        n = 0
        for _hit in batch_overlap_hits(builder, records, min_overlap):
            n += 1
        engine_sec = min(engine_sec, time.time() - t0)
    engine_rps = n / engine_sec

    stages = _stage_breakdown(builder, records, min_overlap)

    # end-to-end `siga overlap` command (FM load + engine + hits + VT/ED)
    import gzip
    import tempfile

    from siga_tpu import cli

    cmd_rps = None
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "reads")
        with open(prefix + ".fa", "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">r{i}\n{s}\n")
        rc = cli.main(["index", "-p", prefix, prefix + ".fa"])
        assert rc in (0, None)
        # best of 2 warm passes
        cmd_sec = float("inf")
        for _rep in range(2):
            t0 = time.time()
            rc = cli.main(
                ["overlap", "-m", str(min_overlap), "-p", prefix, prefix + ".fa"]
            )
            assert rc in (0, None)
            cmd_sec = min(cmd_sec, time.time() - t0)
        cmd_rps = num_reads / cmd_sec

    # gathered bytes of the device scan alone: the pair engine gathers 2
    # rows (228B) per lane-superstep (2 symbols)
    lanes_per_read = 4  # ID/RC lanes on fwd index, REV/COMP on rev index
    maxlen16 = -(-readlen // 16) * 16
    supersteps = maxlen16 // 2
    rows = 2.0 * lanes_per_read * num_reads * supersteps
    occ_bytes = rows * 228.0
    scan_sec = max(stages.get("scan", 0.0), 1e-9)
    occ_gbps = occ_bytes / scan_sec / 1e9
    grows_per_sec = rows / scan_sec / 1e9

    print(
        json.dumps(
            {
                "metric": "overlap_reads_per_sec",
                "value": round(engine_rps, 1),
                "unit": "reads/s",
                "vs_baseline": round(engine_rps / BASELINE_READS_PER_SEC, 3),
                "detail": {
                    "num_reads": n,
                    "readlen": readlen,
                    "min_overlap": min_overlap,
                    "engine_sec": round(engine_sec, 3),
                    "end_to_end_cmd_sec": round(cmd_sec, 3),
                    "end_to_end_cmd_reads_per_sec": round(cmd_rps, 1),
                    "index_build_warm_sec": round(index_warm, 3),
                    "index_build_first_sec": round(index_cold, 3),
                    "index_mchar_per_sec": round(
                        2 * (readlen + 1) * num_reads / index_warm / 1e6, 2
                    ),
                    "occ_gather_gbps": round(occ_gbps, 1),
                    "hbm_frac": round(occ_gbps / PEAK_HBM_GBPS[kind], 3),
                    "occ_grows_per_sec": round(grows_per_sec, 3),
                    "stages_sec": stages,
                    "device_platform": f"{platform}:{kind}",
                    "native_threads": os.cpu_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
