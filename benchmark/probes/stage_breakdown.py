#!/usr/bin/env python3
"""Per-stage breakdown of the overlap engine pass.

Times, with hard device syncs between phases:
  pack    — host 2-bit packing of the chunk
  scan    — device stage-A scan alone (block_until_ready on raw outputs)
  ship    — _pack_v3 + host copy of the packed buffer
  prep    — host searchsorted/_final8 plumbing
  native  — native stage B/C (submaximal + irreducible + serialization prep)
Run: python benchmark/probes/stage_breakdown.py [num_reads]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np

from bench import simulate_reads


def main():
    num_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    readlen = int(os.environ.get("BENCH_READLEN", "100"))
    min_overlap = int(os.environ.get("BENCH_MIN_OVERLAP", "45"))

    from siga_tpu.index import sa as sa_mod
    from siga_tpu.index.fm import FMIndex
    from siga_tpu.io.fastx import DNASeq
    from siga_tpu.overlap.builder import OverlapBuilder
    from siga_tpu.ops import search as search_mod
    from siga_tpu.ops.fm_device import DeviceFM, DualScanner, pack_reads_2bit
    from siga_tpu.ops.search import (
        _bucket_len,
        _bucket_reads,
        _final8_from_cands,
        _native_chunk_processor,
        _with_probe,
        batch_overlap_hits,
    )

    seqs = simulate_reads(num_reads, readlen)
    fwd_codes, _p, rev_codes, _rp, ns = sa_mod.build_index_arrays_pair(
        seqs, use_device=True
    )
    fmi = FMIndex(fwd_codes, ns)
    rfmi = FMIndex(rev_codes, ns)
    builder = OverlapBuilder(fmi, rfmi)
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]

    # warm everything through the normal path first
    for _ in batch_overlap_hits(builder, records, min_overlap):
        pass

    import jax

    dfwd = DeviceFM(fmi)
    drev = DeviceFM(rfmi)
    from siga_tpu.ops.fm_device import GROUP_COMP, GROUP_ID, GROUP_RC, GROUP_REV

    scanner = DualScanner(dfwd, drev, None, (GROUP_ID, GROUP_RC), (GROUP_REV, GROUP_COMP))
    chunk_reads = min(search_mod.CHUNK_READS, max(64, len(records)))
    starts = list(range(0, len(records), chunk_reads))
    proc = _native_chunk_processor(builder)

    tm = {"pack": 0.0, "scan": 0.0, "ship": 0.0, "prep": 0.0, "native": 0.0}

    # one warm pass with the decomposed phases (sticky caps settle)
    def run_pass(tm):
        for start in starts:
            chunk = records[start : start + chunk_reads]
            sqs = [r.seq for r in chunk]
            maxlen = _bucket_len(max(len(s) for s in sqs))
            n_bucket = _bucket_reads(len(chunk), chunk_reads, 1)

            t0 = time.time()
            la_w, lens = pack_reads_2bit(sqs, n_bucket, maxlen)
            la_d, lens_d = scanner._put(la_w, lens)
            tm["pack"] += time.time() - t0

            max_t = maxlen - 1
            lim_t = min(max_t, -(-(int(lens.max()) - 1) // 8) * 8)
            num_lanes = n_bucket * 4
            cap, fcap = scanner._cap, num_lanes
            if scanner._kb == 0:
                scanner._kb = 8192 * 8
            if scanner._kc == 0:
                scanner._kc = 4096 * 6
            kb, kc = min(scanner._kb, cap), min(scanner._kc, fcap)

            t0 = time.time()
            out = scanner._run(cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d)
            jax.block_until_ready(out)
            tm["scan"] += time.time() - t0

            t0 = time.time()
            packed_d = scanner._pack_ship(out, kb, kc)
            handle = (out, packed_d, kb, kc, cap, fcap, n_bucket, max_t,
                      lim_t, min_overlap, la_d, lens_d)
            f_view, r_view = scanner.collect(handle)
            tm["ship"] += time.time() - t0

            t0 = time.time()
            f_lane, f_t, f_data, f_cl, f_cr, f_sub = f_view
            r_lane, r_t, r_data, r_cl, r_cr, r_sub = r_view
            n = len(f_sub) // 2
            f_data = _with_probe(fmi, f_data)
            r_data = _with_probe(rfmi, r_data)
            num_lanes2 = 2 * n
            lens_chunk = np.array([len(r.seq) for r in chunk], dtype=np.int64)
            f_starts = np.searchsorted(f_lane, np.arange(num_lanes2 + 1))
            r_starts = np.searchsorted(r_lane, np.arange(num_lanes2 + 1))
            f_fi = _final8_from_cands(num_lanes2, f_cl, f_cr)
            r_fi = _final8_from_cands(num_lanes2, r_cl, r_cr)
            tm["prep"] += time.time() - t0

            t0 = time.time()
            outs, substr, failed = proc.run(
                lens_chunk, True, True, n,
                (f_starts, f_t, f_data, f_fi, f_sub),
                (r_starts, r_t, r_data, r_fi, r_sub),
            )
            tm["native"] += time.time() - t0
        return tm

    run_pass(dict(tm))  # warm
    t_all = time.time()
    tm = run_pass(tm)
    total = time.time() - t_all

    # scan-only repeated (device busy time, amortized dispatch)
    chunk = records[:chunk_reads]
    sqs = [r.seq for r in chunk]
    maxlen = _bucket_len(max(len(s) for s in sqs))
    n_bucket = _bucket_reads(len(chunk), chunk_reads, 1)
    la_w, lens = pack_reads_2bit(sqs, n_bucket, maxlen)
    la_d, lens_d = scanner._put(la_w, lens)
    max_t = maxlen - 1
    lim_t = min(max_t, -(-(int(lens.max()) - 1) // 8) * 8)
    num_lanes = n_bucket * 4
    cap, fcap = scanner._cap, num_lanes
    out = scanner._run(cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d)
    jax.block_until_ready(out)
    REP = 10
    t0 = time.time()
    for _ in range(REP):
        out = scanner._run(cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d)
    jax.block_until_ready(out)
    scan_rep = (time.time() - t0) / REP

    print(f"reads={num_reads} chunks={len(starts)} lim_t={lim_t} lanes/chunk={num_lanes}")
    for k, v in tm.items():
        print(f"  {k:8s} {v:7.3f}s  ({100*v/total:5.1f}%)")
    print(f"  total    {total:7.3f}s  -> {num_reads/total:.0f} reads/s")
    print(f"  scan-only repeated: {scan_rep*1000:.1f} ms/chunk "
          f"({chunk_reads/scan_rep:.0f} reads/s device-limit)")


if __name__ == "__main__":
    main()
