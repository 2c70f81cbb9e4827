"""`siga rmdup` — duplicate/contained read removal.

Mirrors /root/reference/src/rmdup.cpp + overlap_builder.cpp:514-704: per read,
run the containment-only search (min_overlap = read length); reads flagged
substring or contained (containment with containedIdx==0) go to
<prefix>.rmdup.dups.fa annotated with seqrank, the rest to <prefix>.rmdup.fa;
all reads get a NumDuplicates count.
"""
from __future__ import annotations

import gzip
import sys
from typing import List

from ..constants import BWT_EXT, GZIP_EXT, HITS_EXT, RBWT_EXT, RMDUP_EXT, RSAI_EXT, SAI_EXT
from ..core import devstats
from ..index.fm import FMIndex
from ..io import fastx, sai as sai_mod
from ..overlap.builder import Hit, HitConverter, OverlapBuilder


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: siga rmdup [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    prefix = opts.get("prefix") or fastx.stem(input_path)

    fmi = FMIndex.load(prefix + BWT_EXT)
    rfmi = FMIndex.load(prefix + RBWT_EXT)
    builder = OverlapBuilder(fmi, rfmi, prefix)

    records = fastx.read_sequences(input_path)
    names = [r.name for r in records]
    lengths = [len(r.seq) for r in records]

    # per-"thread" hits shard (single shard = deterministic ordering)
    engine = str(opts.get("engine", "auto"))
    if engine in ("auto", "tpu"):
        from ..ops.search import batch_duplicate_hits

        hits_iter = batch_duplicate_hits(builder, records)
    else:

        def _host():
            for idx, rec in enumerate(records):
                hit = Hit(idx=idx)
                result = builder.duplicate(rec.seq, hit.blocks)
                hit.substring = result.substring
                yield hit

        hits_iter = _host()
    hits_path = f"{prefix}-thread0{RMDUP_EXT}{HITS_EXT}{GZIP_EXT}"
    with gzip.open(hits_path, "wt") as hf:
        for rec, hit in zip(records, hits_iter):
            hf.write(f"{rec.name}\t{rec.seq}\t{hit.serialize()}\n")
    if engine in ("auto", "tpu"):
        from ..ops.search import lane_devices

        devstats.report("rmdup", lane_devices(builder))

    sa_perm, _ = sai_mod.load_sai(prefix + SAI_EXT)
    rsa_perm, _ = sai_mod.load_sai(prefix + RSAI_EXT)
    converter = HitConverter(sa_perm, rsa_perm, names, lengths)

    kept_path = prefix + RMDUP_EXT + ".fa"
    dups_path = prefix + RMDUP_EXT + ".dups.fa"
    with open(kept_path, "w") as kept, open(dups_path, "w") as dups, gzip.open(
        hits_path, "rt"
    ) as hf:
        for line in hf:
            line = line.strip()
            if not line:
                continue
            name, seq, hit_text = line.split("\t", 2)
            hit = Hit.deserialize(hit_text)
            overlaps, num_copies = converter.convert(hit)
            is_contained = hit.substring
            if not is_contained:
                for o in overlaps:
                    if o.is_containment() and o.contained_idx() == 0:
                        is_contained = True
                        break
            # reference meta embeds the read name again
            # (src/overlap_builder.cpp:601-612)
            meta = f"{name} NumDuplicates={num_copies}"
            rec = fastx.DNASeq(seq=seq)
            if is_contained:
                rec.name = f"{name},seqrank={hit.idx} {meta}"
                dups.write(rec.format())
            else:
                rec.name = f"{name} {meta}"
                kept.write(rec.format())
    return 0
