"""`siga overlap` — compute pairwise overlaps, emit ASQG.

Pipeline mirrors /root/reference/src/overlap.cpp + overlap_builder.cpp:423-483:
ASQG header, per-read overlap blocks streamed to hits shard files
({prefix}-thread{i}.hits.gz), VT records in read order (propagating BX/CR/EX
tags from comments), then hits -> ED records via the .sai/.rsai permutations.

The per-thread hits files of the reference map to per-device shards here; the
default single shard reproduces a single-thread reference run ordering.
"""
from __future__ import annotations

import sys
from typing import List

from ..constants import ASQG_EXT, BWT_EXT, GZIP_EXT, HITS_EXT, RBWT_EXT, RSAI_EXT, SAI_EXT
from ..core import devstats
from ..index.fm import FMIndex
from ..io import asqg, fastx, sai as sai_mod
from ..overlap.builder import BatchHitConverter, Hit, HitConverter, OverlapBuilder


def format_vertex_record(rec: fastx.DNASeq, substring: bool) -> str:
    """Fast path of write_vertex_record for comment-less reads (the common
    case); byte-identical to VertexRecord.format."""
    if rec.comment:
        record = asqg.VertexRecord(
            id=rec.name, seq=rec.seq, substring=1 if substring else 0
        )
        for token in rec.comment.split(" "):
            for tag, attr in (
                (asqg.BARCODE_TAG, "barcode"),
                (asqg.COVERAGE_TAG, "coverage"),
                (asqg.EXTENSION_TAG, "ext"),
            ):
                if token.startswith(tag):
                    kv = asqg.parse_tag(token)
                    if kv:
                        setattr(record, attr, kv[1])
        return record.format()
    return f"VT\t{rec.name}\t{rec.seq}\tSS:i:{1 if substring else 0}"


def write_vertex_record(out, rec: fastx.DNASeq, substring: bool) -> None:
    record = asqg.VertexRecord(id=rec.name, seq=rec.seq, substring=1 if substring else 0)
    if rec.comment:
        for token in rec.comment.split(" "):
            if token.startswith(asqg.BARCODE_TAG):
                kv = asqg.parse_tag(token)
                if kv:
                    record.barcode = kv[1]
            elif token.startswith(asqg.COVERAGE_TAG):
                kv = asqg.parse_tag(token)
                if kv:
                    record.coverage = kv[1]
            elif token.startswith(asqg.EXTENSION_TAG):
                kv = asqg.parse_tag(token)
                if kv:
                    record.ext = kv[1]
    out.write(record.format() + "\n")


def build_overlaps(
    input_path: str,
    prefix: str,
    output_path: str,
    min_overlap: int,
    irreducible: bool = True,
    rc: bool = True,
    shards: int = 1,
    engine: str = "auto",
    process_id=None,
    num_processes: int = 1,
    merge_only: bool = False,
) -> bool:
    if process_id is not None and not merge_only:
        # multi-host worker (BASELINE config 5): index replicated in this
        # process, reads sharded round-robin; only this process's residue
        # class is materialized (read_sequences_strided), and it writes
        # exactly the hits shard a single-process `-t N` run would write.
        fmi = FMIndex.load(prefix + BWT_EXT)
        rfmi = FMIndex.load(prefix + RBWT_EXT)
        builder = OverlapBuilder(fmi, rfmi, prefix, irreducible=irreducible, rc=rc)
        subset, gidx = fastx.read_sequences_strided(
            input_path, process_id, num_processes
        )
        shard_path = f"{prefix}-thread{process_id}{HITS_EXT}{GZIP_EXT}"
        from .. import native as native_mod
        from ..ops.search import _blocks_to_array, batch_overlap_hits

        if engine in ("auto", "tpu"):
            hits_iter = batch_overlap_hits(builder, subset, min_overlap)
        else:
            hits_iter = _host_hits(builder, subset, min_overlap)
        native_fmt = native_mod.available()
        with fastx.xopen(shard_path, "wb") as f:
            pend = []
            for local, hit in enumerate(hits_iter):
                hit.idx = gidx[local]
                if native_fmt:
                    arr = getattr(hit, "_array", None)
                    if arr is None:
                        arr = _blocks_to_array(hit.blocks)
                    pend.append((hit.idx, hit.substring, arr))
                    if len(pend) >= 4096:
                        _flush_shard(f, pend)
                else:
                    f.write((hit.serialize() + "\n").encode())
            if pend:
                _flush_shard(f, pend)
        from ..parallel.multihost import barrier

        barrier("overlap-hits")
        return True

    if merge_only:
        return _merge_hits(
            input_path, prefix, output_path, min_overlap, shards,
        )

    records = fastx.read_sequences(input_path)
    names = [r.name for r in records]
    lengths = [len(r.seq) for r in records]

    fmi = FMIndex.load(prefix + BWT_EXT)
    rfmi = FMIndex.load(prefix + RBWT_EXT)
    builder = OverlapBuilder(fmi, rfmi, prefix, irreducible=irreducible, rc=rc)

    out = fastx.xopen(output_path, "wt")
    header = asqg.HeaderRecord(overlap=min_overlap, containment=1, infile=input_path)
    out.write(header.format() + "\n")

    hit_paths = [
        f"{prefix}-thread{i}{HITS_EXT}{GZIP_EXT}" for i in range(max(1, shards))
    ]
    hit_files = [fastx.xopen(p, "wb") for p in hit_paths]

    if engine in ("auto", "tpu"):
        from ..ops.search import batch_overlap_hits

        hits_iter = batch_overlap_hits(builder, records, min_overlap)
    else:
        hits_iter = _host_hits(builder, records, min_overlap)

    from .. import native as native_mod
    from ..ops.search import _blocks_to_array

    native_fmt = native_mod.available()

    # keep the (idx, blocks) arrays in memory while they fit so the ED pass
    # below does not re-read + re-parse the hits files it just wrote (the
    # files remain the stage checkpoint either way)
    MEM_BLOCK_BUDGET = 4_000_000
    in_mem: list = []
    mem_blocks = 0
    pend: list = []  # buffered (idx, substring, arr) awaiting native format

    def flush_hits():
        if not pend:
            return
        blob, offs = native_mod.format_hits(
            [p[0] for p in pend], [p[1] for p in pend], [p[2] for p in pend]
        )
        if len(hit_files) == 1:
            hit_files[0].write(blob)
        else:
            for i, (idx, _s, _a) in enumerate(pend):
                hit_files[idx % len(hit_files)].write(blob[offs[i] : offs[i + 1]])
        pend.clear()

    vt_buf: list = []
    try:
        for idx, (rec, hit) in enumerate(zip(records, hits_iter)):
            arr = getattr(hit, "_array", None)
            if arr is None and (native_fmt or in_mem is not None):
                arr = _blocks_to_array(hit.blocks)
            if native_fmt:
                pend.append((hit.idx, hit.substring, arr))
                if len(pend) >= 4096:
                    flush_hits()
            else:
                hit_files[idx % len(hit_files)].write(
                    (hit.serialize() + "\n").encode()
                )
            vt_buf.append(format_vertex_record(rec, hit.substring))
            if len(vt_buf) >= 4096:
                out.write("\n".join(vt_buf) + "\n")
                vt_buf.clear()
            if in_mem is not None:
                in_mem.append((hit.idx, arr))
                mem_blocks += len(arr)
                if mem_blocks > MEM_BLOCK_BUDGET:
                    in_mem = None  # too big: fall back to re-reading hits
        flush_hits()
        if vt_buf:
            out.write("\n".join(vt_buf) + "\n")
            vt_buf.clear()
    finally:
        for f in hit_files:
            f.close()
    if engine in ("auto", "tpu"):
        from ..ops.search import lane_devices

        devstats.report("overlap", lane_devices(builder))

    sa_perm, _ = sai_mod.load_sai(prefix + SAI_EXT)
    rsa_perm, _ = sai_mod.load_sai(prefix + RSAI_EXT)
    converter = BatchHitConverter(sa_perm, rsa_perm, names, lengths)

    def batches():
        if in_mem is not None:
            # hits were written shard-round-robin; ED order must match the
            # shard-sequential re-read order
            for shard in range(len(hit_paths)):
                yield from in_mem[shard :: len(hit_paths)]
            return
        for path in hit_paths:
            with fastx.xopen(path, "rt") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    idx, _sub, arr = Hit.parse_array(line)
                    yield idx, arr

    batch = []
    for item in batches():
        batch.append(item)
        if len(batch) >= 4096:
            eds = converter.convert_lines(batch)
            if eds:
                out.write("\n".join(eds) + "\n")
            batch = []
    eds = converter.convert_lines(batch)
    if eds:
        out.write("\n".join(eds) + "\n")
    out.close()
    return True


def _flush_shard(f, pend) -> None:
    from .. import native as native_mod

    blob, _offs = native_mod.format_hits(
        [p[0] for p in pend], [p[1] for p in pend], [p[2] for p in pend]
    )
    f.write(blob)
    pend.clear()


def _merge_hits(
    input_path, prefix, output_path, min_overlap, shards,
) -> bool:
    """Merge step of the multi-process overlap: re-read the N hits shard
    files and emit the ASQG (header + VT in read order + ED shard-sequential)
    — byte-identical to a single-process `-t N` run.

    Streaming (BASELINE config 5 data plane): shards are traversed twice —
    once for the per-read substring flags (idx + flag only), once batched
    through the ED converter — and the read set streams through the VT pass
    (only names/lengths are retained), so merge RSS stays flat in shard
    count, shard size, and read-set size."""
    hit_paths = [
        f"{prefix}-thread{i}{HITS_EXT}{GZIP_EXT}" for i in range(max(1, shards))
    ]
    substring = bytearray()
    for path in hit_paths:
        with fastx.xopen(path, "rt") as f:
            for line in f:
                # flags pass: only the first two tokens matter
                parts = line.split(" ", 2)
                if len(parts) >= 2:
                    idx = int(parts[0])
                    if idx >= len(substring):
                        substring.extend(b"\0" * (idx + 1 - len(substring)))
                    substring[idx] = 1 if parts[1] == "1" else 0

    out = fastx.xopen(output_path, "wt")
    header = asqg.HeaderRecord(overlap=min_overlap, containment=1, infile=input_path)
    out.write(header.format() + "\n")
    names: List[str] = []
    lengths: List[int] = []
    for idx, rec in enumerate(fastx.iter_sequences(input_path)):
        sub = bool(substring[idx]) if idx < len(substring) else False
        write_vertex_record(out, rec, sub)
        names.append(rec.name)
        lengths.append(len(rec.seq))

    sa_perm, _ = sai_mod.load_sai(prefix + SAI_EXT)
    rsa_perm, _ = sai_mod.load_sai(prefix + RSAI_EXT)
    converter = BatchHitConverter(sa_perm, rsa_perm, names, lengths)
    batch = []
    for path in hit_paths:
        with fastx.xopen(path, "rt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                idx, _sub, arr = Hit.parse_array(line)
                batch.append((idx, arr))
                if len(batch) >= 4096:
                    eds = converter.convert_lines(batch)
                    if eds:
                        out.write("\n".join(eds) + "\n")
                    batch = []
    eds = converter.convert_lines(batch)
    if eds:
        out.write("\n".join(eds) + "\n")
    out.close()
    return True


def _host_hits(builder: OverlapBuilder, records, min_overlap: int):
    for idx, rec in enumerate(records):
        hit = Hit(idx=idx)
        result = builder.overlap(rec.seq, min_overlap, hit.blocks)
        hit.substring = result.substring
        yield hit


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: siga overlap [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    prefix = opts.get("prefix") or fastx.stem(input_path)
    output = prefix + ASQG_EXT + GZIP_EXT
    process_id = opts.get("process-id")
    if process_id is not None:
        process_id = int(process_id)
        from ..parallel.multihost import init_distributed

        init_distributed()
    ok = build_overlaps(
        input_path,
        prefix,
        output,
        min_overlap=int(opts.get("min-overlap", 10)),
        irreducible=not opts.get("exhaustive"),
        rc=not opts.get("no-opposite-strand"),
        shards=int(opts.get("threads", 1)),
        engine=str(opts.get("engine", "auto")),
        process_id=process_id,
        num_processes=int(opts.get("num-processes", 1)),
        merge_only=bool(opts.get("merge-only")),
    )
    return 0 if ok else 255
