"""Batched overlap detection: device stage-A scan + host finish.

Stage A (the O(reads x readlen) backward-search with '$'-probes) runs on
device via ops/fm_device.py — all reads of a chunk advance one backward-search
step per scan tick, 2 occ gathers per lane per tick shared between probe and
update.  The irregular stages (submaximal filtering, irreducible extension)
reuse the exact host implementations in overlap/builder.py, so both paths emit
identical blocks.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Sequence

import numpy as np

from ..core import dna
from ..index.fm import FMIndex, IntervalPair
from ..overlap.batch_extract import BatchedExtractor, make_task
from ..overlap.builder import (
    AF_PREFIX_PREFIX,
    AF_PREFIX_SUFFIX,
    AF_SUFFIX_PREFIX,
    AF_SUFFIX_SUFFIX,
    Hit,
    OverlapBlock,
    OverlapBuilder,
    OverlapResult,
)
from .fm_device import DeviceFM, DualScanner

CHUNK_READS = int(os.environ.get("SIGA_CHUNK_READS", "16384"))


def _bucket_len(n_chars: int) -> int:
    """Scan-depth bucket: multiple of 16 (the 2-bit word width), floor 64.
    Multiples of 16 instead of pow2 so 100bp reads scan 112 steps, not 128.
    Above 2048 (contig re-overlap territory) buckets widen to pow2/8 so the
    number of distinct compiled scan shapes stays bounded, at the price of
    <=12.5% padded scan work.  The widening point is not yet measured on the
    H100."""
    if n_chars <= 2048:
        return max(64, -(-n_chars // 16) * 16)
    step = 256
    while step * 8 < n_chars:
        step *= 2
    return -(-n_chars // step) * step


def _bucket_reads(n: int, chunk_reads: int, ndev: int) -> int:
    """Lane-count bucket for a (tail) chunk: pow2 up to 2048, then multiples
    of 2048 (the XLA row gather has a large fixed per-call cost, so one big
    tight chunk beats pow2-padded chunks), rounded to the mesh size so
    sharded lanes divide evenly."""
    if n <= 1024:
        b = 1024
    else:
        b = -(-n // 1024) * 1024
    b = min(b, chunk_reads)
    b += (-b) % max(ndev, 1)
    return max(b, n)


def chunk_size(n_rec: int, ndev: int = 1) -> int:
    """Engine chunking policy: smallish equal chunks with deep lookahead.

    Many in-flight chunks hide the dispatch latency, and the host stage-B/C
    runs concurrently with the device stream.  The chunk size is not yet
    measured on the H100."""
    chunk_reads = min(CHUNK_READS, max(64, n_rec))
    if n_rec > 2048:
        n_chunks = max(-(-n_rec // CHUNK_READS), min(8, -(-n_rec // 1024)))
        chunk_reads = -(-n_rec // n_chunks)
    chunk_reads += (-chunk_reads) % max(ndev, 1)
    return chunk_reads


def _pack_lanes(seqs: Sequence[str], num_lanes: int, maxlen: int):
    """Pack to fixed (num_lanes, maxlen) so the scan compiles once.  Padding
    lanes get length 1 (they emit nothing and their containment rows are
    never read)."""
    out = np.zeros((num_lanes, maxlen), dtype=np.int32)
    lens = np.ones(num_lanes, dtype=np.int64)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = dna.encode(s)
        lens[i] = len(s)
    return out, lens


def _final8_from_cands(
    num_lanes: int, cand_lanes: np.ndarray, cand_rows: np.ndarray
) -> np.ndarray:
    """Per-lane [flo,fhi,frlo,frhi, plo,phi,prlo,prhi] for the native chunk
    processor, filled from the device's compacted containment candidates.
    Non-candidate lanes get invalid sentinel pairs (lo=0, hi=-1) so the
    native pair_valid check rejects them without occ work."""
    out = np.empty((num_lanes, 8), dtype=np.int64)
    out[:, 0::2] = 0
    out[:, 1::2] = -1
    if len(cand_lanes):
        flo, fhi, frlo, frhi, l0, u0 = cand_rows.T
        out[cand_lanes] = np.stack(
            [flo, fhi, frlo, frhi, l0, u0 - 1, frlo, frlo + (u0 - l0) - 1],
            axis=1,
        )
    return out


def _with_probe(fmi: FMIndex, data4: np.ndarray) -> np.ndarray:
    """Rebuild 8-col block rows [plo,phi,prlo,prhi, lo,hi,rlo,rhi] from the
    4-col raw intervals the device emits.  The '$'-probe (updateL('$'),
    src/overlap_builder.cpp:112-122 with c='$') is closed-form:
    plo = occ_$(lo-1), phi = occ_$(hi)-1, prlo = rlo, prhi = rlo+diff-1."""
    out = np.empty((data4.shape[0], 8), dtype=np.int64)
    if data4.shape[0] == 0:
        return out
    lo = data4[:, 0].astype(np.int64)
    hi = data4[:, 1].astype(np.int64)
    rlo = data4[:, 2].astype(np.int64)
    dollars = fmi.positions[0]
    l0 = np.searchsorted(dollars, np.clip(lo - 1, -1, fmi.length - 1) + 1)
    u0 = np.searchsorted(dollars, np.clip(hi, -1, fmi.length - 1) + 1)
    out[:, 0] = l0
    out[:, 1] = u0 - 1
    out[:, 2] = rlo
    out[:, 3] = rlo + (u0 - l0) - 1
    out[:, 4:] = data4
    return out


class _ScanBlocks:
    """Per-lane block lists from a compacted scan result."""

    def __init__(self, lane, t, data, num_lanes):
        self.starts = np.searchsorted(lane, np.arange(num_lanes + 1))
        self.t = t
        self.data = data

    def blocks(self, lane: int, af: int) -> List[OverlapBlock]:
        out = []
        for i in range(self.starts[lane], self.starts[lane + 1]):
            e = self.data[i]
            out.append(
                OverlapBlock(
                    IntervalPair(int(e[0]), int(e[1]), int(e[2]), int(e[3])),
                    IntervalPair(int(e[4]), int(e[5]), int(e[6]), int(e[7])),
                    int(self.t[i]) + 1,
                    af,
                )
            )
        return out


class _Containments:
    """Containment/substring classification from the device's compacted
    candidates: substring flags (lext|rext) and probe-valid finals come from
    the scan; only the final updateR('$') counts need one host occ pair over
    the (few) candidates."""

    def __init__(
        self,
        cand_lanes: np.ndarray,
        cand_rows: np.ndarray,
        substr_flags: np.ndarray,
        rindex: FMIndex,
    ):
        self.substring = substr_flags
        self.cand_lanes = cand_lanes
        self.rows = cand_rows
        if len(cand_lanes):
            frlo = cand_rows[:, 2]
            psize = cand_rows[:, 5] - cand_rows[:, 4]
            prhi = frlo + psize - 1
            self.p_l = rindex.occ_all(frlo - 1)
            self.p_u = rindex.occ_all(prhi)

    def get(self, lane: int, seqlen: int, af: int, result: OverlapResult):
        if self.substring[lane]:
            result.substring = True
            return None
        i = int(np.searchsorted(self.cand_lanes, lane))
        if i >= len(self.cand_lanes) or self.cand_lanes[i] != lane:
            return None
        flo, fhi, frlo, frhi, l0, u0 = (int(v) for v in self.rows[i])
        raw = IntervalPair(flo, fhi, frlo, frhi)
        # closed-form '$' probe of the full-length interval, then
        # updateR('$') from the cached counts (pred['$'] == 0)
        probe = IntervalPair(l0, u0 - 1, frlo, frlo + (u0 - l0) - 1)
        assert probe.valid()
        diff0 = int(self.p_u[i, 0] - self.p_l[i, 0])
        probe.hi = probe.lo + diff0 - 1
        probe.rlo = int(self.p_l[i, 0])
        probe.rhi = int(self.p_u[i, 0]) - 1
        assert probe.valid()
        return OverlapBlock(probe, raw, seqlen, af)


def batch_overlap_hits(
    builder: OverlapBuilder, records, min_overlap: int, mesh=None
) -> Iterator[Hit]:
    """Yield one Hit per read (in input order), device stage A + host
    stages B/C.

    With mesh (or multiple visible devices), read lanes shard data-parallel
    across the mesh with the FM-index replicated.  Heterogeneous-length
    inputs (e.g. contig re-overlap) are processed in length-sorted chunks so
    short chunks do not pay the longest read's scan depth; results are
    buffered and re-emitted in input order."""
    lens = [len(r.seq) for r in records]
    lens_sorted = sorted(lens)
    median = lens_sorted[len(lens) // 2]
    if lens_sorted[-1] > 2 * max(median, 1) and len(records) > 1:
        order = sorted(range(len(records)), key=lambda i: lens[i])
        permuted = [records[i] for i in order]
        results = [None] * len(records)
        for pos, hit in zip(order, _batch_overlap_ordered(
            builder, permuted, min_overlap, mesh
        )):
            hit.idx = pos
            results[pos] = hit
        for hit in results:
            yield hit
        return
    yield from _batch_overlap_ordered(builder, records, min_overlap, mesh)


def _batch_overlap_ordered(
    builder: OverlapBuilder, records, min_overlap: int, mesh=None
) -> Iterator[Hit]:
    if mesh is None:
        import jax

        if len(jax.local_devices()) > 1:
            from ..parallel.dist import data_mesh

            mesh = data_mesh()
    fmi, rfmi = builder.fmi, builder.rfmi
    from .fm_device import GROUP_COMP, GROUP_ID, GROUP_RC, GROUP_REV

    if builder.rc:
        fwd_groups, rev_groups = (GROUP_ID, GROUP_RC), (GROUP_REV, GROUP_COMP)
    else:
        fwd_groups, rev_groups = (GROUP_ID,), (GROUP_REV,)
    scanner = _cached_scanner(builder, mesh, fwd_groups, rev_groups)

    # fixed shapes across chunks: one compile serves the whole run; chunk
    # size rounds up to the mesh size so sharded lane counts divide evenly
    ndev = int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1
    chunk_reads = chunk_size(len(records), ndev)

    def dispatch(start):
        chunk = records[start : start + chunk_reads]
        seqs = [r.seq for r in chunk]
        # per-chunk scan depth: read order is preserved, only the compiled
        # shape bucket varies (heterogeneous inputs like contig re-overlap
        # would otherwise pay the global maximum length every chunk)
        maxlen = _bucket_len(max(len(s) for s in seqs))
        # tail chunks scan in a smaller lane bucket instead of paying the
        # full chunk width
        n_bucket = _bucket_reads(len(chunk), chunk_reads, ndev)
        # 2-bit packed upload; all orientation lane groups ([seq, rc(seq)]
        # against the forward index, [reverse(seq), complement(seq)] against
        # the reverse index) are derived on device
        h = scanner.dispatch(seqs, n_bucket, maxlen, min_overlap)
        return chunk, h

    starts = list(range(0, len(records), chunk_reads))
    # chunks in flight: dispatch latency pipelines on device (the depth is
    # not yet measured on the H100)
    LOOKAHEAD = 8
    inflight = [dispatch(s) for s in starts[:LOOKAHEAD]]

    # Stage B/C (native C++) runs in a worker thread one chunk behind the
    # collect loop: ctypes releases the GIL, so the next chunk's device sync
    # and host packing overlap the previous chunk's extraction instead of
    # serializing with it.  One worker keeps chunk results ordered.
    proc0 = _native_chunk_processor(builder)
    executor = None
    n_workers = int(os.environ.get("SIGA_NATIVE_WORKERS", "1"))
    if (
        proc0 is not None
        and len(starts) > 1
        and os.environ.get("SIGA_NATIVE_PIPELINE", "1") != "0"
    ):
        from concurrent.futures import ThreadPoolExecutor

        # >1 worker trades OMP-thread oversubscription for overlap; results
        # stay ordered because the drain below always waits on the OLDEST
        executor = ThreadPoolExecutor(max_workers=n_workers)
    pending_native = []  # (start, chunk, future)
    max_pending = 1 + n_workers

    def native_args(chunk, f_view, r_view):
        f_lane, f_t, f_data, f_cl, f_cr, f_sub = f_view
        r_lane, r_t, r_data, r_cl, r_cr, r_sub = r_view
        n = len(f_sub) // (2 if builder.rc else 1)
        num_lanes = 2 * n if builder.rc else n
        lens_chunk = np.array([len(r.seq) for r in chunk], dtype=np.int64)
        f_starts = np.searchsorted(f_lane, np.arange(num_lanes + 1))
        r_starts = np.searchsorted(r_lane, np.arange(num_lanes + 1))
        f_fi = _final8_from_cands(num_lanes, f_cl, f_cr)
        r_fi = _final8_from_cands(num_lanes, r_cl, r_cr)
        return (
            lens_chunk, builder.rc, builder.irreducible, n,
            (f_starts, f_t, f_data, f_fi, f_sub),
            (r_starts, r_t, r_data, r_fi, r_sub),
        )

    try:
        for ci, start in enumerate(starts):
            chunk, h = inflight.pop(0)
            if ci + LOOKAHEAD < len(starts):
                inflight.append(dispatch(starts[ci + LOOKAHEAD]))
            f_view, r_view = scanner.collect(h)

            if proc0 is not None:
                args = native_args(chunk, f_view, r_view)
                if executor is not None:
                    while len(pending_native) >= max_pending:
                        s0, c0, fut = pending_native.pop(0)
                        outs, substr, _failed = fut.result()
                        for k in range(len(c0)):
                            yield _LazyHit(s0 + k, bool(substr[k]), outs[k])
                    pending_native.append(
                        (start, chunk, executor.submit(proc0.run, *args))
                    )
                else:
                    outs, substr, _failed = proc0.run(*args)
                    for k in range(len(chunk)):
                        yield _LazyHit(start + k, bool(substr[k]), outs[k])
                continue

            f_lane, f_t, f_data, f_cl, f_cr, f_sub = f_view
            r_lane, r_t, r_data, r_cl, r_cr, r_sub = r_view
            n = len(f_sub) // (2 if builder.rc else 1)
            num_lanes = 2 * n if builder.rc else n

            f_data = _with_probe(fmi, f_data)
            r_data = _with_probe(rfmi, r_data)
            f_blocks = _ScanBlocks(f_lane, f_t, f_data, num_lanes)
            r_blocks = _ScanBlocks(r_lane, r_t, r_data, num_lanes)
            f_contain = _Containments(f_cl, f_cr, f_sub, rfmi)
            r_contain = _Containments(r_cl, r_cr, r_sub, fmi)

            pending = []
            tasks = []
            for k, rec in enumerate(chunk):
                seqlen = len(rec.seq)
                result = OverlapResult()
                hit = Hit(idx=start + k)

                suffixfwd = f_blocks.blocks(k, AF_SUFFIX_PREFIX)
                prefixrev = r_blocks.blocks(k, AF_PREFIX_SUFFIX)
                containfwd: List[OverlapBlock] = []
                containrev: List[OverlapBlock] = []
                prefixfwd: List[OverlapBlock] = []
                suffixrev: List[OverlapBlock] = []

                cb = f_contain.get(k, seqlen, AF_SUFFIX_PREFIX, result)
                if cb is not None:
                    containfwd.append(cb)
                cb = r_contain.get(k, seqlen, AF_PREFIX_SUFFIX, result)
                if cb is not None:
                    containrev.append(cb)

                if builder.rc:
                    prefixfwd = f_blocks.blocks(n + k, AF_PREFIX_PREFIX)
                    suffixrev = r_blocks.blocks(n + k, AF_SUFFIX_SUFFIX)
                    cb = f_contain.get(n + k, seqlen, AF_PREFIX_PREFIX, result)
                    if cb is not None:
                        containfwd.append(cb)
                    cb = r_contain.get(n + k, seqlen, AF_SUFFIX_SUFFIX, result)
                    if cb is not None:
                        containrev.append(cb)

                suffix_joined, prefix_joined = builder.prepare_lists(
                    seqlen,
                    suffixfwd,
                    suffixrev,
                    prefixfwd,
                    prefixrev,
                    containfwd,
                    containrev,
                    hit.blocks,
                )
                if builder.irreducible:
                    t_s = make_task((k, 0), suffix_joined)
                    t_p = make_task((k, 1), prefix_joined)
                    tasks.extend((t_s, t_p))
                    pending.append((hit, result, t_s, t_p))
                else:
                    hit.blocks.extend(suffix_joined)
                    hit.blocks.extend(prefix_joined)
                    pending.append((hit, result, None, None))

            if tasks:
                if _native_extractor(builder) is not None:
                    _run_native(builder, tasks)
                else:
                    BatchedExtractor(fmi, rfmi).run(tasks)

            for hit, result, t_s, t_p in pending:
                if t_s is not None:
                    result.aborted |= t_s.failed
                    hit.blocks.extend(t_s.out)
                    result.aborted |= t_p.failed
                    hit.blocks.extend(t_p.out)
                hit.substring = result.substring
                yield hit

        # drain the native pipeline tail
        for s0, c0, fut in pending_native:
            outs, substr, _failed = fut.result()
            for k in range(len(c0)):
                yield _LazyHit(s0 + k, bool(substr[k]), outs[k])
    finally:
        if executor is not None:
            executor.shutdown(wait=True)


class _LazyHit(Hit):
    """Hit backed by a raw (n, 10) block array: serializes without
    materializing OverlapBlock objects; `blocks` builds them on access."""

    def __init__(self, idx, substring, array):
        self.idx = idx
        self.substring = substring
        self._array = array
        self._blocks = None

    @property
    def blocks(self):
        if self._blocks is None:
            self._blocks = _array_to_blocks(self._array)
        return self._blocks

    @blocks.setter
    def blocks(self, value):
        self._blocks = value

    def serialize(self) -> str:
        if self._blocks is not None:
            return Hit.serialize(self)
        rows = self._array.tolist()
        parts = [f"{self.idx} {int(self.substring)} {len(rows)} "]
        for v in rows:
            parts.append(
                f"{v[0]} {v[1]} {v[2]} {v[3]} {v[4]} {v[5]} {v[6]} {v[7]} "
                f"{v[8]} {format(v[9], '03b')} "
            )
        return "".join(parts)


def _cached_scanner(builder, mesh, fwd_groups, rev_groups) -> DualScanner:
    """DualScanner (and its DeviceFM plane uploads) cached on the builder:
    a fresh scanner per batch_overlap_hits call would re-pack and re-upload
    the FM planes every engine pass (~0.5 s/Mchar of index on this host)."""
    key = (id(mesh), fwd_groups, rev_groups)
    cache = getattr(builder, "_scanners", None)
    if cache is None:
        cache = builder._scanners = {}
    scanner = cache.get(key)
    if scanner is None:
        dfms = getattr(builder, "_dfms", None)
        if dfms is None:
            dfms = builder._dfms = (DeviceFM(builder.fmi), DeviceFM(builder.rfmi))
        scanner = DualScanner(dfms[0], dfms[1], mesh, fwd_groups, rev_groups)
        cache[key] = scanner
    return scanner


def lane_devices(builder) -> set:
    """Ids of the devices the builder's scans placed read lanes on."""
    scanners = getattr(builder, "_scanners", {}).values()
    return {i for sc in scanners for i in sc.lane_devices}


def _native_chunk_processor(builder):
    if getattr(builder, "_native_chunk", False) is False:
        from .. import native

        if native.available():
            builder._native_chunk = native.NativeChunkProcessor(
                builder.fmi, builder.rfmi
            )
        else:
            builder._native_chunk = None
    return builder._native_chunk


def _native_extractor(builder):
    if getattr(builder, "_native_ext", False) is False:
        from .. import native

        if native.available():
            builder._native_ext = native.NativeExtractor(builder.fmi, builder.rfmi)
        else:
            builder._native_ext = None
    return builder._native_ext


def _blocks_to_array(blocks) -> np.ndarray:
    a = np.empty((len(blocks), 10), dtype=np.int64)
    for i, b in enumerate(blocks):
        c, r = b.capped, b.raw
        a[i, 0] = c.lo
        a[i, 1] = c.hi
        a[i, 2] = c.rlo
        a[i, 3] = c.rhi
        a[i, 4] = r.lo
        a[i, 5] = r.hi
        a[i, 6] = r.rlo
        a[i, 7] = r.rhi
        a[i, 8] = b.length
        a[i, 9] = b.af
    return a


def _array_to_blocks(a: np.ndarray):
    rows = a.tolist()
    return [
        OverlapBlock(
            IntervalPair(v[0], v[1], v[2], v[3]),
            IntervalPair(v[4], v[5], v[6], v[7]),
            v[8],
            v[9],
        )
        for v in rows
    ]


def _run_native(builder, tasks) -> None:
    ext = _native_extractor(builder)
    arrays = [_blocks_to_array([st.block for st in t.groups[0]]) for t in tasks]
    outs, failed = ext.run(arrays)
    for t, out, f in zip(tasks, outs, failed):
        t.out = _array_to_blocks(out)
        t.failed = bool(f)
        t.groups = []


def batch_duplicate_hits(builder: OverlapBuilder, records, mesh=None):
    """Device-batched rmdup: `duplicate()` is the containment-only search
    (min_overlap = readlen, src/overlap_builder.cpp:1184-1195), i.e. just the
    final-interval classification of the stage-A scan over lanes
    [seq] (forward index) and [complement(seq)] (reverse index)."""
    if mesh is None:
        import jax

        if len(jax.local_devices()) > 1:
            from ..parallel.dist import data_mesh

            mesh = data_mesh()
    fmi, rfmi = builder.fmi, builder.rfmi
    from .fm_device import GROUP_COMP, GROUP_ID

    scanner = _cached_scanner(builder, mesh, (GROUP_ID,), (GROUP_COMP,))

    ndev = int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1
    chunk_reads = chunk_size(len(records), ndev)

    def dispatch(start):
        chunk = records[start : start + chunk_reads]
        seqs = [r.seq for r in chunk]
        maxlen = _bucket_len(max(len(s) for s in seqs))
        n_bucket = _bucket_reads(len(chunk), chunk_reads, ndev)
        # min_overlap > maxlen: no overlap blocks emitted, only finals matter
        h = scanner.dispatch(seqs, n_bucket, maxlen, maxlen + 1)
        return chunk, h

    starts = list(range(0, len(records), chunk_reads))
    LOOKAHEAD = 8
    inflight = [dispatch(s) for s in starts[:LOOKAHEAD]]

    for ci, start in enumerate(starts):
        chunk, h = inflight.pop(0)
        if ci + LOOKAHEAD < len(starts):
            inflight.append(dispatch(starts[ci + LOOKAHEAD]))
        f_view, r_view = scanner.collect(h)
        (_, _, _, f_cl, f_cr, f_sub) = f_view
        (_, _, _, r_cl, r_cr, r_sub) = r_view
        f_contain = _Containments(f_cl, f_cr, f_sub, rfmi)
        r_contain = _Containments(r_cl, r_cr, r_sub, fmi)
        for k, rec in enumerate(chunk):
            seqlen = len(rec.seq)
            result = OverlapResult()
            hit = Hit(idx=start + k)
            cb = f_contain.get(k, seqlen, AF_SUFFIX_PREFIX, result)
            if cb is not None:
                hit.blocks.append(cb)
            cb = r_contain.get(k, seqlen, AF_SUFFIX_SUFFIX, result)
            if cb is not None:
                hit.blocks.append(cb)
            hit.substring = result.substring
            yield hit
