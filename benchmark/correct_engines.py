#!/usr/bin/env python3
"""Corrector count-oracle comparison: device FM backward
search (ops/kmer_count.py) vs the host window table (correct/batch.py) at
the 1 Mb pipeline scale (166k reads, k=41).

The corrector needs counts for all (L-k+1) k-mers of every read
(~18M k-mer queries per round 1 pass).  The host oracle answers them with
one O(n log n) sort-based self-join; the device counter pays a k-step
backward search (2 occ gathers/step) PER QUERY.  This script measures both
on the same index/queries (device timed on a sample, extrapolated) and
prints one JSON line.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    ".scale_test", "ecoli_1.0_25_0.005")


def main():
    from siga_tpu.correct import batch as cb
    from siga_tpu.io import fastx

    k = 41
    reads = fastx.read_sequences(os.path.join(WORK, "reads.pp.fastq"))
    n_queries = sum(max(0, len(r.seq) - k + 1) for r in reads)

    t0 = time.time()
    table = cb.build_window_table_streaming(reads, k)
    t_build = time.time() - t0
    # one full counting pass (the per-round cost)
    sample = reads[:20000]
    lens = np.fromiter((len(r.seq) for r in sample), np.int64, len(sample))
    L = int(lens.max())
    codes = np.zeros((len(sample), L), dtype=np.uint8)
    from siga_tpu.core import dna
    for i, r in enumerate(sample):
        codes[i, : lens[i]] = dna.encode(r.seq)
    hi, lo = cb._window_keys(codes, k)
    valid = (np.arange(L - k + 1)[None, :] + k) <= lens[:, None]
    t0 = time.time()
    host_counts = table.lookup(hi[valid], lo[valid])
    t_host_lookup = time.time() - t0
    host_qps = valid.sum() / t_host_lookup

    # device counter on the same queries (FM index over the read set)
    from siga_tpu.index import sa as sa_mod
    from siga_tpu.index.fm import FMIndex
    from siga_tpu.ops.fm_device import DeviceFM
    from siga_tpu.ops.kmer_count import KmerCounter

    seqs = [r.seq for r in reads]
    fwd, _p, _r, _rp, ns = sa_mod.build_index_arrays_pair(seqs, use_device=True)
    counter = KmerCounter(DeviceFM(FMIndex(fwd, ns)), batch=65536)
    qs = min(131072, int(valid.sum()))
    kmer_rows = codes[:, : L][np.repeat(np.arange(len(sample)), valid.sum(axis=1))]
    # materialize the first qs valid windows as strings
    wlist = []
    for i, r in enumerate(sample):
        for w in range(max(0, len(r.seq) - k + 1)):
            wlist.append(r.seq[w : w + k])
            if len(wlist) >= qs:
                break
        if len(wlist) >= qs:
            break
    counter(wlist[:1024])  # compile
    t0 = time.time()
    dev_counts = counter(wlist)
    t_dev = time.time() - t0
    dev_qps = qs / t_dev
    # equality on the overlapping sample
    hc = host_counts[:qs]
    assert np.array_equal(np.asarray(dev_counts), hc), "oracle mismatch"

    print(json.dumps({
        "metric": "correct_oracle_host_vs_device",
        "value": round(host_qps / dev_qps, 1),
        "unit": "x (host table faster)",
        "detail": {
            "n_reads": len(reads),
            "k": k,
            "total_queries_per_round": n_queries,
            "host_table_build_sec": round(t_build, 1),
            "host_lookup_qps": int(host_qps),
            "device_backward_search_qps": int(dev_qps),
            "device_sample_queries": qs,
            "counts_equal_on_sample": True,
            "est_device_full_pass_sec": round(n_queries / dev_qps, 1),
            "est_host_full_pass_sec": round(
                t_build + n_queries / host_qps, 1
            ),
        },
    }))


if __name__ == "__main__":
    main()
