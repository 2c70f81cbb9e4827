"""`siga index` — build the BWT/FM-index for a set of reads.

Mirrors the reference's src/indexer.cpp: reads stripped of quality/comment,
forward SA+BWT -> .sai/.bwt, then reverse each read (plain reversal, not rc)
and build the reverse index -> .rsai/.rbwt.
"""
from __future__ import annotations

import resource
import sys
import time
from typing import List

import numpy as np

from ..constants import BWT_EXT, RBWT_EXT, RSAI_EXT, SAI_EXT
from ..core import devstats
from ..index import sa as sa_mod
from ..io import bwtio, fastx, sai as sai_mod


def build_one(seqs, sai_path: str, bwt_path: str, use_device: bool) -> None:
    bwt_codes, perm, num_strings = sa_mod.build_index_arrays(seqs, use_device=use_device)
    sai_mod.save_sai(sai_path, perm, num_strings)
    bwtio.save_bwt(bwt_path, bwt_codes, num_strings)


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: siga index [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    output = opts.get("prefix") or fastx.stem(input_path)
    algorithm = str(opts.get("algorithm", "sais2"))
    use_device = algorithm != "host"

    records = fastx.read_sequences(input_path, with_quality=False, with_comment=False)
    seqs = [r.seq for r in records]

    t0 = time.time()
    n_chars = sum(len(s) + 1 for s in seqs)
    builder = sa_mod.choose_builder(n_chars, use_device)
    if not (opts.get("no-forward") or opts.get("no-reverse")):
        # both directions batch into one device program (two rows of the
        # same sort — one launch, one transfer)
        fbwt, fperm, rbwt, rperm, ns = sa_mod.build_index_arrays_pair(
            seqs, use_device=use_device
        )
        sai_mod.save_sai(output + SAI_EXT, fperm, ns)
        bwtio.save_bwt(output + BWT_EXT, fbwt, ns)
        sai_mod.save_sai(output + RSAI_EXT, rperm, ns)
        bwtio.save_bwt(output + RBWT_EXT, rbwt, ns)
    elif not opts.get("no-forward"):
        build_one(seqs, output + SAI_EXT, output + BWT_EXT, use_device)
    elif not opts.get("no-reverse"):
        rev = [s[::-1] for s in seqs]
        build_one(rev, output + RSAI_EXT, output + RBWT_EXT, use_device)
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1073741824.0
    print(
        f"[index] builder: {builder}, chars: {n_chars}, "
        f"wall: {time.time()-t0:.3f} sec, max rss: {maxrss:.3f} GB",
        file=sys.stderr,
    )
    if builder == "device":
        devstats.report("index")
    return 0
