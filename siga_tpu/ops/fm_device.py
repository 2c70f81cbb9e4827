"""Device (JAX) FM-index: HBM-resident BWT codes + checkpoint occ tables.

The layout matches the host FMIndex (index/fm.py) bit-for-bit: codes as uint8
rank symbols, cumulative checkpoint counts every SAMPLE symbols, C array.  A
batched occ query is a checkpoint gather + masked tail reduce, one lane per
query: one gather of a SAMPLE-wide block, then a vectorized compare+sum.
All interval arithmetic is int32 (indices < 2^31).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fm import SAMPLE, FMIndex


class DeviceFM:
    """Immutable device mirror of a host FMIndex.

    BWT symbols live as a (nblocks, sample) row matrix so an occ query is a
    contiguous row gather instead of an element gather.
    `sample` is the device occ-block width — independent of the host
    FMIndex's marker spacing (checkpoints are rebuilt from the codes when it
    differs); narrower rows trade more checkpoint memory for smaller
    per-query gathers.
    """

    def __init__(self, host: FMIndex, sample: int | None = None):
        import os

        if sample is None:
            sample = int(os.environ.get("SIGA_DEV_SAMPLE", SAMPLE))
        assert sample % 32 == 0
        self.sample = sample
        self.length = host.length
        self.num_strings = host.num_strings
        n = host.length
        nblocks = n // sample + 1
        self.nblocks = nblocks
        padded = np.zeros(nblocks * sample, dtype=np.uint8)
        padded[:n] = host.codes
        # Only the fused occ plane (and the tiny pred) go to HBM eagerly:
        # one row gather serves symbol words + '$' mask + checkpoint counts.
        # The separate codes/checkpoints device buffers are lazy — the scan
        # never reads them, so keeping eager copies would roughly double
        # FM-table HBM for nothing.  The single-step word/mask/checkpoint
        # packing is ALSO lazy (_pack_single_step): the default pair-step
        # path builds its plane on device and never touches it, and the
        # eager numpy packing cost 0.4 s of `siga overlap` startup.
        self._host = host
        self._host_padded = padded
        self._host_words = None
        self._host_dollar = None
        self._host_checkpoints = None
        self._host_codes_u8 = np.ascontiguousarray(host.codes)
        self._host_pred = np.asarray(host.pred, dtype=np.int64)
        self.pred = jnp.asarray(host.pred, dtype=jnp.int32)
        # Row-major fused plane [nblocks, ncols]: symbol words | '$'-mask
        # words | ACGT checkpoint counts.  The '$' checkpoint column is NOT
        # stored — checkpoints are exclusive cumulative counts so the five
        # symbols always sum to the block start position, and the occ math
        # derives base_$ = block*sample - sum(base_ACGT).  That keeps ncols
        # at exactly 16 for sample=128: a 64-byte row, and a per-query
        # contiguous row gather (plane[idx]) is the fastest gather form on
        # this hardware.  The popcount math transposes the gathered
        # [Q, 16] tile once and runs full-width on [*, Q] vectors.
        self._occ_plane = None
        self._pair_plane = None
        self._pair_K = None
        self._codes = None
        self._checkpoints = None

    def _pack_single_step(self):
        """Lazy single-step plane components: 2-bit symbol words + '$'
        bitmask ('$' packs as 0, corrected via the mask plane) + exclusive
        checkpoint counts.  Word j of a block covers symbols [16j, 16j+16),
        little-end first."""
        if self._host_words is not None:
            return
        host, sample, nblocks, n = self._host, self.sample, self.nblocks, self.length
        sym = self._host_padded.reshape(nblocks, sample).astype(np.uint32)
        two_bit = np.where(sym == 0, 0, sym - 1)  # $->0(A), A..T -> 0..3
        shifts16 = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
        words = (
            two_bit.reshape(nblocks, sample // 16, 16) << shifts16
        ).sum(axis=2, dtype=np.uint32)
        dbit = (sym == 0).astype(np.uint32)
        shifts32 = np.arange(32, dtype=np.uint32)[None, None, :]
        dollar = (
            dbit.reshape(nblocks, sample // 32, 32) << shifts32
        ).sum(axis=2, dtype=np.uint32)
        if sample == SAMPLE:
            ckpt = np.asarray(host.checkpoints, dtype=np.int32)
        else:
            # exclusive cumulative symbol counts at each block start
            ckpt = np.zeros((nblocks, 5), dtype=np.int32)
            if n:
                key = (np.arange(n, dtype=np.int64) // sample) * 5 + host.codes
                per_block = np.bincount(key, minlength=nblocks * 5).reshape(
                    nblocks, 5
                )
                ckpt[1:] = np.cumsum(per_block[:-1], axis=0, dtype=np.int64)[
                    : nblocks - 1
                ].astype(np.int32)
        self._host_words = words.view(np.int32)
        self._host_dollar = dollar.view(np.int32)
        self._host_checkpoints = ckpt

    @property
    def occ_plane(self):
        if self._occ_plane is None:
            import jax.numpy as jnp

            self._pack_single_step()
            self._occ_plane = jnp.asarray(
                np.ascontiguousarray(
                    np.concatenate(
                        [
                            self._host_words,
                            self._host_dollar,
                            self._host_checkpoints[:, 1:],
                        ],
                        axis=1,
                    )
                )
            )
        return self._occ_plane

    def pair_plane_host(self):
        """Host-side pair-step occ plane: one row per SAMPLE-symbol block,
        serving TWO backward-search steps per gather.

        A row that answers a 2-symbol extension halves both the gather
        count and the sequential scan depth of the stage-A scan, at the
        price of a wider row (228 B against 64 B; the trade is not yet
        measured on the H100).  Row layout (int32 columns, sample=128):
          [ cur 2-bit symbol words (8) | prev 2-bit words (8)
          | cur '$' mask, even-bit format (8) | prev '$' mask (8)
          | 25 exclusive pair checkpoint counts occ2(p,c) (25) ]  = 57 cols.
        `prev` at BWT row r is text[SA[r]-2] = BWT[LF(r)] — the symbol the
        text reads immediately before the row's BWT symbol — so
        occ2((p,c), i) counts rows <= i matching the length-2 left context
        p·c.  The '$' masks use the even-bit (0x5555) format so they AND
        directly with the 2-bit-symbol match masks.

        Returns (plane int32 [nblocks, 57], K int64 [5,5]) where
        K[c2][c1] = C(c2) + occ_{c2}(C(c1)-1) closes the two-step update
        lo' = K[c2][c1] + occ2((c2,c1), lo-1)  (see _scan_pair_core).
        """
        sample = self.sample
        codes = self._host_codes_u8
        n = codes.size
        nblocks = self.nblocks
        if sample == 128:
            from .. import native as native_mod

            if native_mod.available():
                plane = np.empty((nblocks, PAIR_COLS), dtype=np.int32)
                K = np.empty(25, dtype=np.int64)
                import ctypes

                lib = native_mod.get_lib()
                lib.siga_pack_pair_plane.restype = None
                lib.siga_pack_pair_plane(
                    codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.c_int64(n),
                    plane.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    K.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                )
                return plane, K.reshape(5, 5)
        # LF mapping via counting sort (O(n), beats argsort ~4x at 10Mchar):
        # row r's LF is pred[codes[r]] + its occurrence ordinal.
        pred64 = self._host_pred
        lf = np.empty(n, dtype=np.int64)
        for c in range(5):
            pos_c = np.flatnonzero(codes == c)
            lf[pos_c] = pred64[c] + np.arange(pos_c.size, dtype=np.int64)
        prev = codes[lf]
        prev[codes == 0] = 0  # cur='$' rows are never queried by pair
        padded_prev = np.zeros(nblocks * sample, dtype=np.uint8)
        padded_prev[:n] = prev

        def two_bit_words(padded):
            sym = padded.reshape(nblocks, sample).astype(np.uint32)
            tb = np.where(sym == 0, 0, sym - 1)
            sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
            return (tb.reshape(nblocks, sample // 16, 16) << sh).sum(
                axis=2, dtype=np.uint32
            )

        def dollar_even_words(padded):
            # '$' mask in even-bit format: position j -> bit 2*(j%16)
            db = (padded.reshape(nblocks, sample) == 0).astype(np.uint32)
            sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
            return (db.reshape(nblocks, sample // 16, 16) << sh).sum(
                axis=2, dtype=np.uint32
            )

        curw = two_bit_words(self._host_padded)
        prevw = two_bit_words(padded_prev)
        curd = dollar_even_words(self._host_padded)
        prevd = dollar_even_words(padded_prev)
        ckpt2 = np.zeros((nblocks, 25), dtype=np.int64)
        if n:
            key = (np.arange(n, dtype=np.int64) // sample) * 25
            key += prev.astype(np.int64) * 5 + codes
            per_block = np.bincount(key, minlength=nblocks * 25).reshape(
                nblocks, 25
            )
            ckpt2[1:] = np.cumsum(per_block[:-1], axis=0, dtype=np.int64)
        assert ckpt2.max(initial=0) < 2**31
        plane = np.concatenate(
            [
                curw.view(np.int32),
                prevw.view(np.int32),
                curd.view(np.int32),
                prevd.view(np.int32),
                ckpt2.astype(np.int32),
            ],
            axis=1,
        )
        # K[c2][c1] = C(c2) + occ_{c2}(C(c1)-1): occ at the 5 C-boundaries
        # computed from the codes directly (no positions lists)
        pred = self._host_pred
        K = np.zeros((5, 5), dtype=np.int64)
        for c1 in range(5):
            p = int(pred[c1])  # count symbols in codes[:p]
            counts = np.bincount(codes[:p], minlength=5).astype(np.int64)
            K[:, c1] = pred + counts
        return np.ascontiguousarray(plane), K

    def pair_plane(self):
        import jax.numpy as jnp

        if self._pair_plane is None:
            plane, K = self.pair_plane_host()
            self._pair_plane = jnp.asarray(plane)
            self._pair_K = jnp.asarray(K.astype(np.int32))
        return self._pair_plane, self._pair_K

    def pair_plane_device(self):
        """Pair plane + K built ON DEVICE from the 4-bit-packed text.

        The host path packs a [nblocks, 57] int32 plane (228 B/block = 1.78
        B/char) and uploads it; this path uploads the text 4-bit packed
        (0.5 B/char, 3.6x fewer bytes) and derives the LF mapping, prev-symbol words, '$' masks, pair checkpoints, and the
        K closure matrix in one jitted program.  Bit-identical to
        pair_plane_host (tests/test_pair_scan.py::test_device_plane_parity).
        """
        import jax.numpy as jnp

        assert self.sample == 128, "pair plane is built at sample=128"
        # bucket the program shape (pow2 then pow2/8 granules, like
        # index/sa.py::_pad_size) so differently-sized indexes share the
        # compiled builder; the padded tail is masked out and sliced away.
        # The bucket sizes are not yet measured on the H100.
        nb = 8
        while nb < self.nblocks and nb < 8192:
            nb *= 2
        if self.nblocks > nb:
            step = max(nb // 8, 1)
            nb = -(-self.nblocks // step) * step
        padded = np.zeros(nb * self.sample, dtype=np.uint8)
        padded[: self._host_padded.size] = self._host_padded
        codes4 = padded[0::2] | (padded[1::2] << 4)
        plane, K = _build_pair_plane_dev(
            nb,
            self.sample,
            jnp.asarray(codes4),
            jnp.int32(self.length),
            jnp.asarray(self._host_pred.astype(np.int32)),
        )
        return plane[: self.nblocks], K

    @property
    def codes(self):
        if self._codes is None:
            self._codes = jnp.asarray(
                self._host_padded.reshape(self.nblocks, self.sample)
            )
        return self._codes

    @property
    def checkpoints(self):
        if self._checkpoints is None:
            self._pack_single_step()
            self._checkpoints = jnp.asarray(self._host_checkpoints)
        return self._checkpoints


def occ_all(codes, checkpoints, length, i):
    """Batched inclusive occ counts: i int32 [...], -> [..., 5] int32.

    codes is the (nblocks, sample) row matrix (sample inferred from its
    width); one row gather + masked compare-sum per query.  The '$' count is
    derived from the tail length so only 4 compare passes run.
    occ(c, -1) == 0 by construction (pos=0 -> empty tail, checkpoint 0).
    """
    sample = codes.shape[-1]
    pos = i + 1
    block = pos // sample
    base = checkpoints[block]
    rows = codes[block]  # [..., sample] contiguous row gather
    offs = jnp.arange(sample, dtype=jnp.int32)
    tail_len = pos - block * sample
    mask = offs < tail_len[..., None]
    counts = [
        jnp.sum((rows == c) & mask, axis=-1, dtype=jnp.int32) for c in range(1, 5)
    ]
    acgt = jnp.stack(counts, axis=-1)
    dollar = tail_len - acgt.sum(axis=-1)
    return base + jnp.concatenate([dollar[..., None], acgt], axis=-1)


_NWORDS = SAMPLE // 16
_NDWORDS = SAMPLE // 32
PLANE_COLS = _NWORDS + _NDWORDS + 4  # symbol words | '$' words | ACGT ckpts


def _plane_sample(ncols: int) -> int:
    """Infer the occ block width from the fused plane's column count:
    ncols = s/16 + s/32 + 4  =>  s = 32*(ncols-4)/3."""
    s = 32 * (ncols - 4) // 3
    assert s % 32 == 0 and s // 16 + s // 32 + 4 == ncols, ncols
    return s


def _occ_from_rows(rows, block0, tail_len, sample):
    """Popcount occ counts from gathered row-major plane rows.

    rows: [Q, ncols] gathered plane rows (symbol words | '$'-mask words |
    ACGT checkpoint counts); block0: [Q] POSITION block index (excluding
    any stacked-table offset); tail_len: [Q].  Returns [5, Q] int32
    inclusive counts.  The '$' checkpoint is derived, not stored:
    checkpoints are exclusive cumulative counts so base_$ = block0*sample -
    sum(base_ACGT).  The gathered [Q, ncols] tile is transposed once; all
    mask/popcount math then runs with the query axis minor."""
    nwords = sample // 16
    ndwords = sample // 32
    popcount = jax.lax.population_count
    rowsT = rows.T                                  # [ncols, Q]
    w = rowsT[:nwords].astype(jnp.uint32)           # [nwords, Q]
    d = rowsT[nwords:nwords + ndwords].astype(jnp.uint32)
    base_acgt = rowsT[nwords + ndwords:]            # [4, Q]
    tail = tail_len.astype(jnp.int32)

    widx = (jnp.arange(nwords, dtype=jnp.int32) * 16)[:, None]
    valid = jnp.clip(tail[None, :] - widx, 0, 16).astype(jnp.uint32)
    wmask = jnp.where(
        valid == 16, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << (2 * valid)) - 1
    )
    didx = (jnp.arange(ndwords, dtype=jnp.int32) * 32)[:, None]
    dvalid = jnp.clip(tail[None, :] - didx, 0, 32).astype(jnp.uint32)
    dmask = jnp.where(
        dvalid == 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << dvalid) - 1
    )
    n_dollar = popcount(d & dmask).sum(axis=0).astype(jnp.int32)
    lo_bits = jnp.uint32(0x55555555)

    def count2(pattern):
        x = w ^ pattern
        matched = ~(x | (x >> 1)) & lo_bits
        return popcount(matched & wmask).sum(axis=0).astype(jnp.int32)

    c_a = count2(jnp.uint32(0x00000000)) - n_dollar  # '$' packs as 0
    c_c = count2(lo_bits)
    c_g = count2(jnp.uint32(0xAAAAAAAA))
    c_t = count2(jnp.uint32(0xFFFFFFFF))
    base_dollar = block0 * sample - base_acgt.sum(axis=0)
    acgt = base_acgt + jnp.stack([c_a, c_c, c_g, c_t], axis=0)
    return jnp.concatenate([(base_dollar + n_dollar)[None, :], acgt], axis=0)


def occ_all_fused_T(plane, length, i, tab=None):
    """Row-gather occ over the fused [rows, ncols] plane:
    i int32 [Q] -> [5, Q] inclusive counts.

    ONE contiguous row gather per query (plane[idx]), then a full-width
    popcount.  The block width s is
    inferred from the plane's static column count."""
    sample = _plane_sample(plane.shape[-1])
    pos = i + 1
    block0 = pos // sample
    block = block0 if tab is None else block0 + tab
    rows = plane[block]  # [Q, ncols] single row gather
    return _occ_from_rows(rows, block0, pos - block0 * sample, sample)


def occ_all_fused(plane, length, i, tab=None):
    """Row-gather occ with query-major output: i int32 [Q] -> [Q, 5]."""
    return occ_all_fused_T(plane, length, i, tab).T


def occ_all_fused_sharded_T(plane_local, length, i, tab, bps, axis):
    """Sharded row-gather occ: each device holds a contiguous ROW range of
    the (stacked fwd+rev) fused plane; every device answers the queries
    whose global block row falls in its shard (others contribute zeros)
    and a psum combines.  SURVEY §2.9 "index sharding" — no reference
    analog.  Returns [5, Q]."""
    sample = _plane_sample(plane_local.shape[-1])
    pos = i + 1
    block0 = pos // sample
    block = block0 if tab is None else block0 + tab
    local = block - jax.lax.axis_index(axis) * bps
    in_range = (local >= 0) & (local < bps)
    rows = plane_local[jnp.clip(local, 0, bps - 1)]
    counts = _occ_from_rows(rows, block0, pos - block0 * sample, sample)
    counts = jnp.where(in_range[None, :], counts, 0)
    return jax.lax.psum(counts, axis)


def _update_left_T(lo, hi, rlo, rhi, c, l_counts, u_counts, pred):
    """IntervalPair.updateL on [Q] vectors with [5, Q] occ counts.

    Mirrors src/overlap_builder.cpp:112-122; the 5-way rank selects unroll
    statically (full-width selects, no [Q, 5] minor-dim-5 arrays)."""
    diff = u_counts - l_counts  # [5, Q]
    below = jnp.zeros_like(lo)
    dc = jnp.zeros_like(lo)
    lc = jnp.zeros_like(lo)
    uc = jnp.zeros_like(lo)
    pb = jnp.zeros_like(lo)
    for r in range(5):
        sel = c == r
        below = below + jnp.where(c > r, diff[r], 0)
        dc = jnp.where(sel, diff[r], dc)
        lc = jnp.where(sel, l_counts[r], lc)
        uc = jnp.where(sel, u_counts[r], uc)
        pb = jnp.where(sel, pred[r], pb)
    nrlo = rlo + below
    nrhi = nrlo + dc - 1
    nlo = pb + lc
    nhi = pb + uc - 1
    return nlo, nhi, nrlo, nrhi


def update_left_core(lo, hi, rlo, rhi, c, l_counts, u_counts, pred):
    """IntervalPair.updateL with precomputed occ counts at lo-1 and hi.

    c: int32 [...] symbol rank.  Returns (lo, hi, rlo, rhi) after prepending c.
    Mirrors src/overlap_builder.cpp:112-122.  All rank selections are one-hot
    masked reductions instead of per-element gathers (take_along_axis,
    pred[c]).
    """
    diff = u_counts - l_counts  # [..., 5]
    ranks = jnp.arange(5, dtype=jnp.int32)
    onehot = ranks == c[..., None]
    below = jnp.sum(jnp.where(ranks < c[..., None], diff, 0), axis=-1)
    dc = jnp.sum(jnp.where(onehot, diff, 0), axis=-1)
    lc = jnp.sum(jnp.where(onehot, l_counts, 0), axis=-1)
    uc = jnp.sum(jnp.where(onehot, u_counts, 0), axis=-1)
    pb = jnp.sum(jnp.where(onehot, pred, 0), axis=-1)
    nrlo = rlo + below
    nrhi = nrlo + dc - 1
    nlo = pb + lc
    nhi = pb + uc - 1
    return nlo, nhi, nrlo, nrhi


def _unpack_2bit(words, lens, maxlen, right_align):
    """(n, maxlen//16) packed 2-bit words -> (n, maxlen) int32 ranks 1..4,
    0 outside the read span."""
    w = words.astype(jnp.uint32)
    j = jnp.arange(maxlen, dtype=jnp.int32)
    sym = ((jnp.repeat(w, 16, axis=1) >> (2 * (j % 16))[None, :].astype(jnp.uint32))
           & 3).astype(jnp.int32) + 1
    if right_align:
        mask = j[None, :] >= (maxlen - lens)[:, None]
    else:
        mask = j[None, :] < lens[:, None]
    return jnp.where(mask, sym, 0)


def _complement_ranks(c):
    # A<->T, C<->G on ranks 1..4; '$'/pad (0) unchanged
    return jnp.where(c == 0, 0, 5 - c)


# Lane-group transform ids: how a lane's scan sequence derives from the read.
GROUP_ID = 0       # seq itself (suffix search in the forward index)
GROUP_RC = 1       # reverse_complement(seq) (forward index)
GROUP_REV = 2      # reverse(seq) (reverse index)
GROUP_COMP = 3     # complement(seq) (reverse index)


def _pack_bits32(flags):
    """bool [L] -> packed int32 words [ceil(L/32)] (bit j of word w =
    flags[32w+j])."""
    L = flags.shape[0]
    nw = -(-L // 32)
    pad = jnp.pad(flags.astype(jnp.uint32), (0, nw * 32 - L))
    j = jnp.arange(32, dtype=jnp.uint32)
    words = (pad.reshape(nw, 32) << j[None, :]).sum(axis=1, dtype=jnp.uint32)
    return words.astype(jnp.int32)


def _scan_packed_core(
    max_t, lim_t, min_overlap, cap, fcap, fwd_groups, rev_groups, occ_shard,
    plane, pred, length, nblocks,
    la_words, lens,
):
    """Stage-A scan over 2-bit packed reads: the production overlap kernel.

    Only the left-aligned packing is uploaded (~2 bits per char);
    the right-aligned view and every orientation group's per-step character
    matrix derive on device.  For a lane scanning transformed sequence s' the
    scan wants chars[:, t] = s'[l-2-t] and chars[:, max_t] = s'[l-1]
    (src/overlap_builder.cpp:846-906 reads the query right-to-left); with
    ra[j] = seq[j-(L-l)] those are static columns:
      identity:   seq[l-2-t]        = roll(flip(ra), -1)
      rc:         comp(seq[t+1])    = comp(roll(la, -1))
      reverse:    seq[t+1]          = roll(la, -1)
      complement: comp(seq[l-2-t])  = comp(roll(flip(ra), -1))

    The scan runs in two phases: a no-emission warmup for t < min_overlap-1
    (blocks there can never be emitted, src/overlap_builder.cpp:857-874
    requires overlap >= minOverlap) and an emitting phase after, so the
    compaction nonzero only sweeps the steps that can produce blocks.  The
    '$'-probe is closed-form ('$' is rank 0 with pred 0: plo = occ_$(lo-1),
    size = occ_$(hi)-occ_$(lo-1), prlo = rlo), saving one update_left_core
    per step.

    Per-lane containment/substring classification also happens here: lext
    from the lane's own table, rext from the other table (the stacked plane
    holds both), probe-valid finals compacted to fcap candidate rows
    [flo, fhi, frlo, frhi, occ_$(flo-1), occ_$(fhi)] — replacing a full
    per-lane final transfer and host occ passes.

    Returns (counts[2], idx[cap], data[cap,3], fidx[fcap], frows[fcap,6],
    subwords[ceil(lanes/32)]); idx = lane*T2 + (t - (min_overlap-1)),
    lane-major ascending.
    """
    maxlen = max_t + 1
    la = _unpack_2bit(la_words, lens, maxlen, right_align=False)
    # right-aligned view via a per-lane shift on device instead of
    # uploading a second packing
    j = jnp.arange(maxlen, dtype=jnp.int32)[None, :]
    src = j - (maxlen - lens)[:, None]
    ra = jnp.where(
        src >= 0,
        jnp.take_along_axis(la, jnp.clip(src, 0, maxlen - 1), axis=1),
        0,
    )
    rra_roll = jnp.roll(jnp.flip(ra, axis=1), -1, axis=1)
    la_roll = jnp.roll(la, -1, axis=1)
    group_chars = {
        GROUP_ID: lambda: rra_roll,
        GROUP_RC: lambda: _complement_ranks(la_roll),
        GROUP_REV: lambda: la_roll,
        GROUP_COMP: lambda: _complement_ranks(rra_roll),
    }
    n = lens.shape[0]
    groups = tuple(fwd_groups) + tuple(rev_groups)
    # transposed chars [maxlen, lanes]: each scan step consumes one
    # contiguous row via xs (the old chars[:, t] was a strided column read
    # of a [lanes, maxlen] matrix every step)
    charsT = jnp.concatenate([group_chars[g]() for g in groups], axis=0).T
    lens_all = jnp.tile(lens, (len(groups),))
    nf, nr = len(fwd_groups), len(rev_groups)
    tab = jnp.concatenate(
        [jnp.zeros(n * nf, jnp.int32), jnp.full((n * nr,), 1, jnp.int32) * nblocks]
    )
    tab_other = nblocks - tab
    num_lanes = charsT.shape[1]
    tab2 = jnp.concatenate([tab, tab])
    tab2_other = jnp.concatenate([tab_other, tab_other])

    if occ_shard is None:
        def occ(i, tabs):
            return occ_all_fused_T(plane, length, i, tabs)
    else:
        bps, axis = occ_shard

        def occ(i, tabs):
            return occ_all_fused_sharded_T(plane, length, i, tabs, bps, axis)

    c0 = charsT[max_t]  # charsT[T] holds s'[l-1]
    lo0 = pred[c0]
    full = occ(jnp.full((num_lanes,), 1, jnp.int32) * (length - 1), tab)
    hi0 = lo0 + jnp.take_along_axis(full, c0[None, :], axis=0)[0] - 1
    state0 = (lo0, hi0, lo0, hi0)

    def step_core(state, c, t, emit):
        lo, hi, rlo, rhi = state
        both = occ(jnp.concatenate([lo - 1, hi]), tab2)  # [5, 2Q]
        l_counts = both[:, :num_lanes]
        u_counts = both[:, num_lanes:]
        active = t <= lens_all - 2
        nlo, nhi, nrlo, nrhi = _update_left_T(
            lo, hi, rlo, rhi, c, l_counts, u_counts, pred
        )
        ns = (
            jnp.where(active, nlo, lo),
            jnp.where(active, nhi, hi),
            jnp.where(active, nrlo, rlo),
            jnp.where(active, nrhi, rhi),
        )
        if not emit:
            return ns, ()
        # closed-form '$' probe: prlo = rlo, prhi = rlo + psize - 1
        psize = u_counts[0] - l_counts[0]
        emit_valid = (psize > 0) & (rlo + psize - 1 >= 0) & active
        emitted = jnp.stack([lo, rlo, hi - lo], axis=0)  # [3, Q]
        return ns, (emitted, emit_valid)

    p1 = min(max(min_overlap - 1, 0), lim_t)
    T2 = lim_t - p1
    ts = jnp.arange(lim_t, dtype=jnp.int32)
    s1, _ = jax.lax.scan(
        lambda s, xs: step_core(s, xs[0], xs[1], False), state0,
        (charsT[:p1], ts[:p1]),
    )
    if T2 > 0:
        s2, (emitted, valid) = jax.lax.scan(
            lambda s, xs: step_core(s, xs[0], xs[1], True), s1,
            (charsT[p1:lim_t], ts[p1:]),
        )
    else:
        s2 = s1
    flo, fhi, frlo, frhi = s2

    # finals: lext from own table, rext from the other table, closed probe
    both = occ(jnp.concatenate([flo - 1, fhi]), tab2)
    l_counts = both[:, :num_lanes]
    u_counts = both[:, num_lanes:]
    lext_dna = (u_counts[1:] - l_counts[1:]).sum(axis=0) > 0
    both_r = occ(jnp.concatenate([frlo - 1, frhi]), tab2_other)
    rext_dna = (both_r[1:, num_lanes:] - both_r[1:, :num_lanes]).sum(axis=0) > 0
    substring = lext_dna | rext_dna
    l0 = l_counts[0]
    u0 = u_counts[0]
    psize_f = u0 - l0
    # probe pair validity (native pair_valid semantics, extractor.cpp:321):
    # probe = (l0, u0-1, frlo, frlo+psize-1)
    fvalid = (psize_f > 0) & (u0 - 1 >= 0) & (frlo + psize_f - 1 >= 0) & (
        frlo + psize_f - 1 >= frlo
    )
    fcount = fvalid.sum(dtype=jnp.int32)
    (fidx,) = jnp.nonzero(fvalid, size=fcap, fill_value=num_lanes - 1)
    # transposed [6, fcap]: compacted rows stay lane-minor (no minor-dim-6
    # tile padding)
    fall = jnp.stack([flo, fhi, frlo, frhi, l0, u0], axis=0)
    frowsT = jnp.take_along_axis(fall, jnp.broadcast_to(fidx[None, :], (6, fcap)), axis=1)
    subwords = _pack_bits32(substring)

    if T2 > 0:
        # lane-major flat index = lane*T2 + trel
        vT = valid.T.reshape(-1)
        count = vT.sum(dtype=jnp.int32)
        (idx,) = jnp.nonzero(vT, size=cap, fill_value=T2 * num_lanes - 1)
        eT = emitted.transpose(1, 2, 0).reshape(3, num_lanes * T2)
        dataT = jnp.take_along_axis(
            eT, jnp.broadcast_to(idx[None, :], (3, cap)), axis=1
        )
        idx = idx.astype(jnp.int32)
    else:
        count = jnp.int32(0)
        idx = jnp.zeros((cap,), jnp.int32)
        dataT = jnp.zeros((3, cap), jnp.int32)
    counts = jnp.stack([count, fcount])
    return counts, idx, dataT, fidx.astype(jnp.int32), frowsT.astype(jnp.int32), subwords


_scan_packed_v2 = partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6, 7))(
    _scan_packed_core
)


# ---------------------------------------------------------------------------
# Pair-step scan: two backward-search steps per occ gather.
#
# The 228-byte pair row (symbols + prev-symbols + '$' masks + 25 pair
# checkpoints) serves a 2-symbol extension with one gather, where the 64-byte
# single-step row serves one symbol: half the gathered rows and half the
# sequential scan depth, for 3.6x the bytes per row.  Which row wins on the
# H100 is not yet measured.
#
# Math (no reference analog):
#   one step:   lo' = C(c1) + occ_{c1}(lo-1)
#   two steps:  lo'' = K[c2][c1] + occ2((c2,c1), lo-1)
#     where occ2((p,c), i) = #\{r <= i : BWT[r]=c and text[SA[r]-2]=p\}
#     and   K[c2][c1] = C(c2) + occ_{c2}(C(c1)-1)
#   (rows < lo' with BWT=c1 map 1:1 under LF to rows < C(c1) plus rows whose
#    pair context is (c2,c1); the fixed prefix contributes the K constant.)
# The intermediate state (after c1 only) and both '$'-probes derive from the
# same gathered row: psize(t) from the cur-'$' mask, psize(t+1) from the
# ('$',c1) pair count.
# ---------------------------------------------------------------------------

PAIR_COLS = 57  # 8 cur + 8 prev + 8 cur$ + 8 prev$ + 25 ckpt (sample=128)
_LO_BITS = jnp.uint32(0x55555555)


@partial(jax.jit, static_argnums=(0, 1))
def _build_pair_plane_dev(nblocks, sample, codes4, n_real, pred):
    """Device pair-plane construction: codes4 uint8 [nblocks*sample/2]
    (2 rank codes per byte, pad 0 beyond n_real) -> (plane int32
    [nblocks, 57], K int32 [5, 5]).  Mirrors pair_plane_host bit-for-bit:
    prev at BWT row r is codes[LF(r)] (0 for '$' rows), masks in even-bit
    format, 25 exclusive pair checkpoints, K[c2][c1] = C(c2) +
    occ_{c2}(C(c1)-1)."""
    n_pad = nblocks * sample
    lo4 = (codes4 & 0xF).astype(jnp.uint8)
    hi4 = (codes4 >> 4).astype(jnp.uint8)
    codes = jnp.stack([lo4, hi4], axis=1).reshape(n_pad).astype(jnp.int32)
    posn = jnp.arange(n_pad, dtype=jnp.int32)
    valid = posn < n_real

    # LF via per-symbol exclusive ordinals (pads sit past every real row,
    # so unmasked cumsums stay correct for real rows)
    lf = jnp.zeros(n_pad, jnp.int32)
    for c in range(5):
        is_c = codes == c
        ord_c = jnp.cumsum(is_c.astype(jnp.int32)) - is_c
        lf = jnp.where(is_c, pred[c] + ord_c, lf)
    prev = codes[jnp.clip(lf, 0, n_pad - 1)]
    prev = jnp.where((codes == 0) | ~valid, 0, prev)

    shifts16 = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]

    def two_bit_words(sym):
        tb = jnp.where(sym == 0, 0, sym - 1).astype(jnp.uint32)
        return (
            tb.reshape(nblocks, sample // 16, 16) << shifts16
        ).sum(axis=2, dtype=jnp.uint32)

    def dollar_even_words(sym):
        db = (sym == 0).astype(jnp.uint32)
        return (
            db.reshape(nblocks, sample // 16, 16) << shifts16
        ).sum(axis=2, dtype=jnp.uint32)

    curw = two_bit_words(codes)
    prevw = two_bit_words(prev)
    curd = dollar_even_words(codes)
    prevd = dollar_even_words(prev)

    key = jnp.where(valid, prev * 5 + codes, 25).reshape(nblocks, sample)
    per_block = jnp.stack(
        [(key == k).sum(axis=1, dtype=jnp.int32) for k in range(25)], axis=1
    )
    ckpt2 = jnp.cumsum(per_block, axis=0, dtype=jnp.int32) - per_block

    plane = jnp.concatenate(
        [
            curw.astype(jnp.int32),
            prevw.astype(jnp.int32),
            curd.astype(jnp.int32),
            prevd.astype(jnp.int32),
            ckpt2,
        ],
        axis=1,
    )
    # K[c2][c1] = C(c2) + occ_{c2}(C(c1)-1): 5 singles queries on the plane
    singles, _ = _pair_occ(
        plane[pred // sample].T, pred // sample, pred - (pred // sample) * sample,
        None, False,
    )  # singles[c2, j] = occ_{c2}(pred[j] - 1)
    K = pred[:, None] + singles
    return plane, K.astype(jnp.int32)


def _pair_masks(rowsT, want_prev):
    """Even-bit match masks for each symbol from a transposed pair-plane
    gather.  rowsT: [PAIR_COLS, R] int32.  Returns (cur_masks[5], prev_masks
    [5] or None, wmask_fn) where masks are uint32 [8, R] with bit 2k set iff
    symbol k of the word matches."""
    curw = rowsT[0:8].astype(jnp.uint32)
    prevw = rowsT[8:16].astype(jnp.uint32)
    curd = rowsT[16:24].astype(jnp.uint32)
    prevd = rowsT[24:32].astype(jnp.uint32)

    def match2(w, pattern):
        x = w ^ pattern
        return ~(x | (x >> 1)) & _LO_BITS

    def masks(w, d):
        mA = match2(w, jnp.uint32(0)) & ~d
        mC = match2(w, _LO_BITS)
        mG = match2(w, jnp.uint32(0xAAAAAAAA))
        mT = match2(w, jnp.uint32(0xFFFFFFFF))
        return (d, mA, mC, mG, mT)

    cur = masks(curw, curd)
    prev = masks(prevw, prevd) if want_prev else None
    return cur, prev


def _tail_wmask(tail_len):
    """[8, R] uint32 valid-position mask (2 bits per symbol, low-first)."""
    widx = (jnp.arange(8, dtype=jnp.int32) * 16)[:, None]
    valid = jnp.clip(tail_len[None, :] - widx, 0, 16).astype(jnp.uint32)
    return jnp.where(
        valid == 16, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << (2 * valid)) - 1
    )


def _popsum(mask):
    return jax.lax.population_count(mask).sum(axis=0).astype(jnp.int32)


def _pair_occ(rowsT, block0, tail_len, c1, want_pairs):
    """Inclusive occ counts from gathered pair-plane rows.

    rowsT [PAIR_COLS, R]; block0/tail_len [R]; c1 [R] (symbol prepended
    first; only used when want_pairs).  Returns (singles [5, R],
    pairs [5, R] or None) where pairs[p] = occ2((p, c1), i)."""
    ckpt = rowsT[32:57]  # [25, R] exclusive base counts, key p*5+c
    cur, prev = _pair_masks(rowsT, want_pairs)
    wmask = _tail_wmask(tail_len)

    base_sing = [
        ckpt[0 + c] + ckpt[5 + c] + ckpt[10 + c] + ckpt[15 + c] + ckpt[20 + c]
        for c in range(5)
    ]
    singles = jnp.stack(
        [base_sing[c] + _popsum(cur[c] & wmask) for c in range(5)], axis=0
    )
    if not want_pairs:
        return singles, None
    # cur-mask and ckpt column selected by the per-lane c1 (c1 in 1..4; the
    # c1==0 case only occurs on masked garbage lanes)
    m_c1 = jnp.zeros_like(cur[1])
    for c in range(1, 5):
        m_c1 = jnp.where(c1[None, :] == c, cur[c], m_c1)
    pairs_rows = []
    for p in range(5):
        base = jnp.zeros_like(block0)
        for c in range(1, 5):
            base = jnp.where(c1 == c, ckpt[p * 5 + c], base)
        pairs_rows.append(base + _popsum(prev[p] & m_c1 & wmask))
    return singles, jnp.stack(pairs_rows, axis=0)


def _sel_rank(vec5, c):
    """vec5 [5, Q] selected by rank c [Q] -> [Q] (unrolled selects)."""
    out = jnp.where(c == 0, vec5[0], 0)
    for r in range(1, 5):
        out = jnp.where(c == r, vec5[r], out)
    return out


def _below_rank(vec5, c):
    """sum of vec5[r] for r < c (per lane)."""
    out = jnp.zeros_like(vec5[0])
    for r in range(5):
        out = out + jnp.where(c > r, vec5[r], 0)
    return out


def _scan_pair_core(
    max_t, lim_t, min_overlap, cap, fcap, fwd_groups, rev_groups,
    plane2, K2, pred, length, nblocks,
    la_words, lens,
):
    """Stage-A scan, pair-step engine (2 backward steps per gather).

    Emits the same per-(lane, t) records as _scan_packed_core, compacted
    lane-major t-ascending, plus per-lane block counts so the wire format
    ships no flat indices.  Outputs (all device):
      counts[4] = [nblocks, fcount, size_ovf, cand_ovf]
      lane_counts int32 [lanes]
      data3T [3, cap] = lo | rlo | size   (lane-major, t-ascending)
      trel  int32 [cap]                   (t - t0, t0 = 2*(p1//2))
      candmask int32 [ceil(lanes/32)]
      candT [5, fcap] = flo | frlo | l0 | fsize | psize
      subwords int32 [ceil(lanes/32)]
    """
    maxlen = max_t + 1
    la = _unpack_2bit(la_words, lens, maxlen, right_align=False)
    j = jnp.arange(maxlen, dtype=jnp.int32)[None, :]
    src = j - (maxlen - lens)[:, None]
    ra = jnp.where(
        src >= 0,
        jnp.take_along_axis(la, jnp.clip(src, 0, maxlen - 1), axis=1),
        0,
    )
    rra_roll = jnp.roll(jnp.flip(ra, axis=1), -1, axis=1)
    la_roll = jnp.roll(la, -1, axis=1)
    group_chars = {
        GROUP_ID: lambda: rra_roll,
        GROUP_RC: lambda: _complement_ranks(la_roll),
        GROUP_REV: lambda: la_roll,
        GROUP_COMP: lambda: _complement_ranks(rra_roll),
    }
    n = lens.shape[0]
    groups = tuple(fwd_groups) + tuple(rev_groups)
    charsT = jnp.concatenate([group_chars[g]() for g in groups], axis=0).T
    lens_all = jnp.tile(lens, (len(groups),))
    nf, nr = len(fwd_groups), len(rev_groups)
    tab = jnp.concatenate(
        [jnp.zeros(n * nf, jnp.int32), jnp.full((n * nr,), 1, jnp.int32) * nblocks]
    )
    num_lanes = charsT.shape[1]
    is_fwd = jnp.arange(num_lanes, dtype=jnp.int32) < n * nf
    tab2 = jnp.concatenate([tab, tab])
    is_fwd2 = jnp.concatenate([is_fwd, is_fwd])
    sample = _plane_sample_pair(plane2.shape[-1])

    def gather(i):
        pos = i + 1
        block0 = pos // sample
        rows = plane2[block0 + tab2]
        return rows.T, block0, pos - block0 * sample

    def occ_singles(i, tabs):
        pos = i + 1
        block0 = pos // sample
        rows = plane2[block0 + tabs]
        singles, _ = _pair_occ(rows.T, block0, pos - block0 * sample, None, False)
        return singles

    def Ksel(c2, c1):
        out = jnp.zeros_like(c1)
        for a in range(1, 5):
            for b in range(1, 5):
                out = jnp.where(
                    (c2 == a) & (c1 == b),
                    jnp.where(is_fwd, K2[0, a, b], K2[1, a, b]),
                    out,
                )
        return out

    # init with the last character of each read
    c0 = charsT[max_t]
    lo0 = pred[c0]
    full = occ_singles(jnp.full((num_lanes,), 1, jnp.int32) * (length - 1), tab)
    hi0 = lo0 + jnp.take_along_axis(full, c0[None, :], axis=0)[0] - 1
    state0 = (lo0, hi0, lo0, hi0)

    p1 = min(max(min_overlap - 1, 0), lim_t)
    t0 = 2 * (p1 // 2)
    lim2 = lim_t + (lim_t & 1)  # odd lim_t: a masked phantom half-step pads
    S_warm = p1 // 2
    S_emit = (lim2 - t0) // 2
    T2 = lim2 - t0

    def superstep(state, xs, emit):
        (c1, c2), t = xs
        lo, hi, rlo, rhi = state
        rowsT, block0, tail = gather(jnp.concatenate([lo - 1, hi]))
        c1_2 = jnp.concatenate([c1, c1])
        singles, pairs = _pair_occ(rowsT, block0, tail, c1_2, True)
        l_s, u_s = singles[:, :num_lanes], singles[:, num_lanes:]
        l_p, u_p = pairs[:, :num_lanes], pairs[:, num_lanes:]
        diff = u_s - l_s
        pd = u_p - l_p
        active1 = t <= lens_all - 2
        active2 = t + 1 <= lens_all - 2
        # sub-state 1 (prepend c1)
        d1 = _sel_rank(diff, c1)
        nlo1 = _sel_rank(pred[:, None] + l_s, c1)
        nhi1 = _sel_rank(pred[:, None] + u_s, c1) - 1
        nrlo1 = rlo + _below_rank(diff, c1)
        nrhi1 = nrlo1 + d1 - 1
        # state 2 (prepend c2): two-step closed form via K + pair occ
        Kv = Ksel(c2, c1)
        nlo2 = Kv + _sel_rank(l_p, c2)
        nhi2 = Kv + _sel_rank(u_p, c2) - 1
        d2 = _sel_rank(pd, c2)
        nrlo2 = nrlo1 + _below_rank(pd, c2)
        nrhi2 = nrlo2 + d2 - 1
        ns = (
            jnp.where(active2, nlo2, jnp.where(active1, nlo1, lo)),
            jnp.where(active2, nhi2, jnp.where(active1, nhi1, hi)),
            jnp.where(active2, nrlo2, jnp.where(active1, nrlo1, rlo)),
            jnp.where(active2, nrhi2, jnp.where(active1, nrhi1, rhi)),
        )
        if not emit:
            return ns, ()
        # emission at state t (psize from cur-'$' singles)
        psize0 = diff[0]
        valid0 = (
            (psize0 > 0) & (rlo + psize0 - 1 >= 0) & active1 & (t >= p1)
        )
        emit0 = jnp.stack([lo, rlo, hi - lo], axis=0)
        # emission at state t+1 (psize from the ('$', c1) pair count)
        psize1 = pd[0]
        valid1 = (
            (psize1 > 0) & (nrlo1 + psize1 - 1 >= 0) & active2 & (t + 1 >= p1)
        )
        emit1 = jnp.stack([nlo1, nrlo1, d1 - 1], axis=0)
        emitted = jnp.stack([emit0, emit1], axis=1)  # [3, 2, Q]
        valid = jnp.stack([valid0, valid1], axis=0)  # [2, Q]
        return ns, (emitted, valid)

    chars_used = charsT[:lim_t]
    if lim2 != lim_t:
        chars_used = jnp.concatenate(
            [chars_used, jnp.zeros((1, num_lanes), chars_used.dtype)]
        )
    chars_pairs = chars_used.reshape(lim2 // 2, 2, num_lanes)
    ts = jnp.arange(0, lim2, 2, dtype=jnp.int32)
    s1, _ = jax.lax.scan(
        lambda s, xs: superstep(s, xs, False), state0,
        ((chars_pairs[:S_warm, 0], chars_pairs[:S_warm, 1]), ts[:S_warm]),
    )
    if S_emit > 0:
        s2, (emitted, valid) = jax.lax.scan(
            lambda s, xs: superstep(s, xs, True), s1,
            (
                (chars_pairs[S_warm:, 0], chars_pairs[S_warm:, 1]),
                ts[S_warm:],
            ),
        )
    else:
        s2 = s1
    flo, fhi, frlo, frhi = s2

    # finals: containment/substring classification (as _scan_packed_core)
    fs = occ_singles(jnp.concatenate([flo - 1, fhi]), tab2)
    l_counts, u_counts = fs[:, :num_lanes], fs[:, num_lanes:]
    lext_dna = (u_counts[1:] - l_counts[1:]).sum(axis=0) > 0
    tab2_other = jnp.concatenate([nblocks - tab, nblocks - tab])
    fr = occ_singles(jnp.concatenate([frlo - 1, frhi]), tab2_other)
    rext_dna = (fr[1:, num_lanes:] - fr[1:, :num_lanes]).sum(axis=0) > 0
    substring = lext_dna | rext_dna
    l0 = l_counts[0]
    u0 = u_counts[0]
    psize_f = u0 - l0
    fvalid = (psize_f > 0) & (u0 - 1 >= 0) & (frlo + psize_f - 1 >= 0) & (
        frlo + psize_f - 1 >= frlo
    )
    fcount = fvalid.sum(dtype=jnp.int32)
    (fidx,) = jnp.nonzero(fvalid, size=fcap, fill_value=num_lanes - 1)
    fall = jnp.stack([flo, frlo, l0, fhi - flo, psize_f], axis=0)
    candT = jnp.take_along_axis(
        fall, jnp.broadcast_to(fidx[None, :], (5, fcap)), axis=1
    )
    fmask = jnp.arange(fcap, dtype=jnp.int32) < fcount
    cand_ovf = jnp.any(
        jnp.where(fmask[None, :], candT[3:5], 0) >= 0xFFFF
    ).astype(jnp.int32)
    candmask = _pack_bits32(fvalid)
    subwords = _pack_bits32(substring)

    if S_emit > 0:
        # Two-level compaction instead of a full-grid nonzero over the
        # [lanes*T2] flat index space: (1) left-pack each lane's T2-wide
        # row with a small minor-axis sort (local), then (2) one
        # flat gather of exactly `cap` packed entries addressed through the
        # per-lane prefix sums.
        def to_rows(x):  # [S2, 2, Q] -> [Q, T2], t ascending per lane
            return x.transpose(2, 0, 1).reshape(num_lanes, T2)

        trel_grid = (
            2 * jnp.arange(S_emit, dtype=jnp.int32)[:, None, None]
            + jnp.arange(2, dtype=jnp.int32)[None, :, None]
        )
        key = jnp.where(
            valid, jnp.broadcast_to(trel_grid, valid.shape), jnp.int32(0x7FFFFFFF)
        )
        ks, los, rlos, szs = jax.lax.sort(
            (
                to_rows(key),
                to_rows(emitted[:, 0]),
                to_rows(emitted[:, 1]),
                to_rows(emitted[:, 2]),
            ),
            dimension=-1,
            num_keys=1,
        )
        lane_counts = valid.sum(axis=(0, 1)).astype(jnp.int32)
        prefix = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(lane_counts, dtype=jnp.int32)]
        )
        count = prefix[-1]
        seg = jnp.zeros((cap + 1,), jnp.int32).at[
            jnp.clip(prefix[1:], 0, cap)
        ].add(1)
        lane_of = jnp.cumsum(seg[:cap], dtype=jnp.int32)
        j_of = jnp.arange(cap, dtype=jnp.int32) - prefix[lane_of]
        src = jnp.clip(lane_of * T2 + j_of, 0, num_lanes * T2 - 1)
        data3T = jnp.stack(
            [los.reshape(-1)[src], rlos.reshape(-1)[src], szs.reshape(-1)[src]]
        )
        trel = ks.reshape(-1)[src]
        bmask = jnp.arange(cap, dtype=jnp.int32) < count
        size_ovf = jnp.any(
            jnp.where(bmask, data3T[2], 0) >= 0xFFFF
        ).astype(jnp.int32)
    else:
        count = jnp.int32(0)
        data3T = jnp.zeros((3, cap), jnp.int32)
        trel = jnp.zeros((cap,), jnp.int32)
        lane_counts = jnp.zeros((num_lanes,), jnp.int32)
        size_ovf = jnp.int32(0)
    counts = jnp.stack([count, fcount, size_ovf, cand_ovf])
    return (counts, lane_counts, data3T, trel, candmask, candT, subwords)


def _plane_sample_pair(ncols: int) -> int:
    """sample from the pair plane's column count: 32 mask/word cols + 25."""
    s = (ncols - 25) * 4
    assert s % 32 == 0 and ncols == PAIR_COLS or s % 32 == 0, ncols
    return s


_scan_pair_v1 = partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6))(
    _scan_pair_core
)


@partial(jax.jit, static_argnums=(0, 1))
def _pack_pair_compact(kb, kc, out):
    """Compact wire format for the pair scan (decoded in collect):
    [header8 | lane_counts u16-packed | lo kb | rlo kb | szt kb
     | candmask | flo kc | frlo kc | l0 kc | szpsz kc | subwords]
    where szt = trel<<16 | size and szpsz = fsize<<16 | psize.
    Valid only when the header overflow flags are 0 (host re-packs wide
    otherwise)."""
    counts, lane_counts, data3T, trel, candmask, candT, subwords = out
    header = jnp.concatenate([counts, jnp.zeros((4,), jnp.int32)])
    lc = lane_counts.reshape(-1, 2)
    lc_pack = lc[:, 0] | (lc[:, 1] << 16)
    szt = (trel[:kb] << 16) | (data3T[2, :kb] & 0xFFFF)
    szpsz = (jnp.clip(candT[3, :kc], 0, 0xFFFF) << 16) | (
        jnp.clip(candT[4, :kc], 0, 0xFFFF)
    )
    return jnp.concatenate(
        [
            header,
            lc_pack,
            data3T[0, :kb],
            data3T[1, :kb],
            szt,
            candmask,
            candT[0, :kc],
            candT[1, :kc],
            candT[2, :kc],
            szpsz,
            subwords,
        ]
    )


@partial(jax.jit, static_argnums=(0, 1))
def _pack_pair_wide(kb, kc, out):
    """Wide wire format (no field-packing) for overflow cases."""
    counts, lane_counts, data3T, trel, candmask, candT, subwords = out
    header = jnp.concatenate([counts, jnp.zeros((4,), jnp.int32)])
    lc = lane_counts.reshape(-1, 2)
    lc_pack = lc[:, 0] | (lc[:, 1] << 16)
    return jnp.concatenate(
        [
            header,
            lc_pack,
            data3T[:, :kb].reshape(-1),
            trel[:kb],
            candmask,
            candT[:, :kc].reshape(-1),
            subwords,
        ]
    )


def _build_sharded_scan(mesh, axis, statics):
    """Compile the stage-A scan with the fused occ plane SA-range-sharded
    over the mesh: every device holds 1/D of the (stacked fwd+rev) plane
    rows and the per-step occ is answered by owner shards + psum
    (occ_all_fused_sharded).  Lanes are replicated — this is the capacity
    mode for indexes larger than one device's HBM (SURVEY §2.9 index
    sharding; BASELINE >HBM axis), trading redundant lane compute for a
    D-fold larger addressable index."""
    from jax.sharding import PartitionSpec as P

    core = partial(_scan_packed_core, *statics)
    fn = jax.shard_map(
        core,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


@partial(jax.jit, static_argnums=(0, 1))
def _pack_v3(kb, kc, counts, idx, data, fidx, frows, subwords):
    """Fuse the compacted scan outputs into ONE int32 buffer with the counts
    embedded in a 4-int header, sliced to the (kb, kc) transfer budgets.

    The caller enqueues this right after the scan and starts the host copy
    asynchronously, so the whole chunk costs exactly one host sync instead
    of a count-sync/pack/fetch sequence of three."""
    header = jnp.concatenate([counts, jnp.zeros((2,), jnp.int32)])
    return jnp.concatenate(
        [
            header,
            idx[:kb],
            data[:, :kb].reshape(-1),
            fidx[:kc],
            frows[:, :kc].reshape(-1),
            subwords,
        ]
    )


@partial(jax.jit, static_argnums=(0, 1))
def _scan_stage_a(max_t, min_overlap, plane, pred, length, chars, lens, lane_tab=None):
    """Backward-search scan with '$'-probes over a batch of lanes.

    chars: int32 [L, T] update symbols (chars[:, t] = seq[l-2-t], garbage when
      t >= l-1); lens: int32 [L] read lengths.
    Returns per-step probe/raw intervals + validity and the final full-length
    interval state per lane.
    """
    num_lanes = chars.shape[0]
    tab1 = lane_tab
    tab2 = None if lane_tab is None else jnp.concatenate([lane_tab, lane_tab])

    def occ(i, tab):
        return occ_all_fused(plane, length, i, tab)

    # init with the last character of each read: interval over all of fmi
    c0 = chars[:, max_t]  # by construction chars[:, T] holds seq[l-1]
    lo0 = pred[c0]
    # totals = checkpoints-based full counts via occ(length-1)
    full = occ(jnp.full((num_lanes,), length - 1, dtype=jnp.int32), tab1)
    hi0 = lo0 + jnp.take_along_axis(full, c0[..., None], axis=-1)[..., 0] - 1
    state0 = (lo0, hi0, lo0, hi0)

    def step(state, t):
        lo, hi, rlo, rhi = state
        both = occ(jnp.concatenate([lo - 1, hi]), tab2)
        l_counts = both[:num_lanes]
        u_counts = both[num_lanes:]
        # probe: extend left with '$' (rank 0)
        zeros = jnp.zeros_like(lo)
        plo, phi, prlo, prhi = update_left_core(
            lo, hi, rlo, rhi, zeros, l_counts, u_counts, pred
        )
        probe_valid = (prhi >= prlo) & (prhi >= 0)
        active = t <= lens - 2
        overlap_len = t + 1
        emit_valid = probe_valid & active & (overlap_len >= min_overlap)
        # emit only [lo, rlo, size]: hi = lo+size and rhi = rlo+size by the
        # IntervalPair size invariant, and the '$'-probe (capped) columns are
        # a closed-form function of (lo, hi, rlo) + occ_$ rebuilt on host for
        # just the emitted blocks (ops/search.py::_with_probe) — cutting the
        # scan's device-memory writes and the transfer to 3/8 of the naive
        # 8-column emission
        emitted = jnp.stack([lo, rlo, hi - lo], axis=-1)
        # update with the actual character
        c = chars[:, t]
        nlo, nhi, nrlo, nrhi = update_left_core(
            lo, hi, rlo, rhi, c, l_counts, u_counts, pred
        )
        new_state = (
            jnp.where(active, nlo, lo),
            jnp.where(active, nhi, hi),
            jnp.where(active, nrlo, rlo),
            jnp.where(active, nrhi, rhi),
        )
        return new_state, (emitted, emit_valid)

    final_state, (emitted, valid) = jax.lax.scan(
        step, state0, jnp.arange(max_t, dtype=jnp.int32)
    )
    flo, fhi, frlo, frhi = final_state
    # containment classification on the full-length interval
    both = occ(jnp.concatenate([flo - 1, fhi]), tab2)
    l_counts = both[:num_lanes]
    u_counts = both[num_lanes:]
    lext = u_counts - l_counts
    zeros = jnp.zeros_like(flo)
    plo, phi, prlo, prhi = update_left_core(
        flo, fhi, frlo, frhi, zeros, l_counts, u_counts, pred
    )
    final = jnp.stack([flo, fhi, frlo, frhi, plo, phi, prlo, prhi], axis=-1)
    return emitted, valid, final, lext


def _granule(n: int, g: int) -> int:
    """Round n up to a multiple of g (bounded distinct transfer shapes)."""
    return max(g, -(-n // g) * g)


def _next_pow2(n: int) -> int:
    p = 1024
    while p < n:
        p *= 2
    return p


def pack_reads_2bit(seqs, n: int, maxlen: int):
    """Host-side 2-bit left-aligned packing of a chunk of reads.

    Returns (la_words, lens): (n, maxlen//16) int32 packed words (symbol j in
    bits [2j%32, 2j%32+2) of word j//16) and int32 lengths.  Empty/padding
    rows get length 1 (their lanes never emit).

    The packing runs in C++ when available (siga_pack_reads_2bit); the
    numpy shift/sum path below is the checked fallback that raises on
    non-ACGT bytes and on reads longer than maxlen."""
    from .. import native as native_mod

    if native_mod.available():
        import ctypes

        lib = native_mod.get_lib()
        joined = "".join(seqs).encode()
        buf = np.frombuffer(joined, dtype=np.uint8)
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs)),
            out=offsets[1:],
        )
        la_w = np.empty((n, maxlen // 16), dtype=np.int32)
        lens = np.empty(n, dtype=np.int32)
        rc = lib.siga_pack_reads_2bit(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(seqs)),
            ctypes.c_int64(n),
            ctypes.c_int64(maxlen),
            la_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == 0:
            return la_w, lens
        # non-ACGT bytes: fall through for the checked error path
    from ..core import dna

    lens = np.ones(n, dtype=np.int32)
    real_lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=len(seqs))
    if real_lens.size and int(real_lens.max()) > maxlen:
        raise ValueError(f"read longer than the packed width {maxlen}")
    lens[: len(seqs)] = np.maximum(real_lens, 1)
    flat = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
    enc = dna.RANK_LUT[flat]
    if enc.size and enc.min() == 0:
        # rank 0 would underflow the 2-bit packing and carry-corrupt the
        # whole containing word; the device engine only handles pure
        # ACGT reads (the host engine treats rank 0 as a '$' update)
        raise ValueError(
            "read contains non-ACGT symbols; run `siga preprocess` "
            "first or use --engine=host"
        )
    codes = enc - 1
    la = np.zeros((n, maxlen), dtype=np.uint32)
    if real_lens.size and int(real_lens.min()) == int(real_lens.max()):
        # uniform read length (the common short-read case): one reshape copy
        # instead of a total-bases fancy scatter (~7x less host time/chunk)
        L = int(real_lens[0])
        la[: len(seqs), :L] = codes.reshape(len(seqs), L)
    else:
        # scatter each read's codes into its left-aligned row (the
        # right-aligned view is derived on device, _scan_packed_v2)
        total = int(real_lens.sum())
        row = np.repeat(np.arange(len(seqs), dtype=np.int64), real_lens)
        intra = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(real_lens, dtype=np.int64) - real_lens, real_lens
        )
        la[row, intra] = codes
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    w = maxlen // 16
    la_w = (la.reshape(n, w, 16) << shifts).sum(axis=2, dtype=np.uint32)
    return la_w.view(np.int32), lens


class DualScanner:
    """One scan call serves both (fwd, rev) orientation pairs: the two
    indexes' tables are stacked and each lane carries a block-table offset.
    The C arrays of the forward and reversed text are identical (same symbol
    totals), so `pred` is shared.

    Reads are uploaded 2-bit packed (left-aligned only); the
    right-aligned view and the per-step character matrices of all
    orientation lane groups are derived on device (_scan_packed_v2).  Lane
    layout: fwd-index groups first, then rev-index groups, each with
    stride n."""

    def __init__(self, dfwd: DeviceFM, drev: DeviceFM, mesh=None,
                 fwd_groups=(GROUP_ID, GROUP_RC),
                 rev_groups=(GROUP_REV, GROUP_COMP),
                 shard_index: bool = False,
                 pair_step: bool | None = None):
        import os

        assert dfwd.length == drev.length
        assert dfwd.sample == drev.sample and dfwd.nblocks == drev.nblocks
        self.length = dfwd.length
        self.nblocks = dfwd.nblocks
        self.fwd_groups = tuple(fwd_groups)
        self.rev_groups = tuple(rev_groups)
        if pair_step is None:
            pair_step = os.environ.get("SIGA_PAIR_STEP", "1") != "0"
        # the sharded capacity mode still runs the single-step core
        self.pair = bool(pair_step) and not shard_index
        if self.pair:
            if os.environ.get("SIGA_PAIR_PLANE", "device") == "host":
                fp = dfwd._pair_host if getattr(dfwd, "_pair_host", None) else None
                if fp is None:
                    fp = dfwd._pair_host = dfwd.pair_plane_host()
                rp = getattr(drev, "_pair_host", None)
                if rp is None:
                    rp = drev._pair_host = drev.pair_plane_host()
                plane = jnp.asarray(
                    np.ascontiguousarray(np.concatenate([fp[0], rp[0]], axis=0))
                )
                self.K2 = jnp.asarray(
                    np.stack([fp[1], rp[1]]).astype(np.int32)
                )
            else:
                # build on device from the 4-bit-packed text: 3.6x fewer
                # upload bytes than shipping the packed plane
                fp = getattr(dfwd, "_pair_dev", None)
                if fp is None:
                    fp = dfwd._pair_dev = dfwd.pair_plane_device()
                rp = getattr(drev, "_pair_dev", None)
                if rp is None:
                    rp = drev._pair_dev = drev.pair_plane_device()
                plane = jnp.concatenate([fp[0], rp[0]], axis=0)
                self.K2 = jnp.stack([fp[1], rp[1]])
        else:
            plane = jnp.concatenate([dfwd.occ_plane, drev.occ_plane], axis=0)
        self.pred = dfwd.pred
        self.mesh = mesh
        self.lane_devices = set()  # ids of the devices lanes were placed on
        self._occ_shard = None
        self._sharded_fns = {}
        if mesh is not None and shard_index:
            # SA-range index sharding: 1/D of the stacked plane's block
            # rows per device (capacity mode for >HBM indexes); reads
            # replicated.
            from jax.sharding import NamedSharding, PartitionSpec as P

            ndev = mesh.shape["data"]
            rows = int(plane.shape[0])
            pad = (-rows) % ndev
            plane = jnp.pad(plane, ((0, pad), (0, 0)))
            plane = jax.device_put(plane, NamedSharding(mesh, P("data", None)))
            self.pred = jax.device_put(self.pred, NamedSharding(mesh, P()))
            self._occ_shard = ((rows + pad) // ndev, "data")
            repl = NamedSharding(mesh, P())
            self._lane_sharding = repl
            self._vec_sharding = repl
        elif mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            repl = NamedSharding(mesh, P())
            plane = jax.device_put(plane, repl)
            self.pred = jax.device_put(self.pred, repl)
            self._lane_sharding = NamedSharding(mesh, P("data", None))
            self._vec_sharding = NamedSharding(mesh, P("data"))
        self.plane = plane
        # start at the cap a coverage~5 short-read chunk needs: a too-small
        # cap costs a full re-scan + a fresh compile on the first chunk,
        # while an oversized cap only costs device-side scratch (transfers
        # slice to the observed count)
        self._cap = 65536
        # sticky transfer budgets (slices of the compacted outputs actually
        # copied to host); overflow re-packs from the live scan outputs
        self._kb = 0
        self._kc = 0

    def _put(self, la_w, lens):
        if self.mesh is None:
            la_d, lens_d = jnp.asarray(la_w), jnp.asarray(lens)
        else:
            la_d = jax.device_put(la_w, self._lane_sharding)
            lens_d = jax.device_put(lens, self._vec_sharding)
        self.lane_devices.update(d.id for d in la_d.sharding.device_set)
        return la_d, lens_d

    def _run(self, cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d):
        if self.pair:
            return _scan_pair_v1(
                max_t, lim_t, min_overlap, cap, fcap,
                self.fwd_groups, self.rev_groups,
                self.plane, self.K2, self.pred,
                jnp.int32(self.length), jnp.int32(self.nblocks),
                la_d, lens_d,
            )
        if self._occ_shard is not None:
            statics = (
                max_t, lim_t, min_overlap, cap, fcap,
                self.fwd_groups, self.rev_groups, self._occ_shard,
            )
            fn = self._sharded_fns.get(statics)
            if fn is None:
                fn = _build_sharded_scan(self.mesh, "data", statics)
                self._sharded_fns[statics] = fn
            return fn(
                self.plane, self.pred,
                jnp.int32(self.length), jnp.int32(self.nblocks),
                la_d, lens_d,
            )
        return _scan_packed_v2(
            max_t, lim_t, min_overlap, cap, fcap, self.fwd_groups, self.rev_groups,
            None, self.plane, self.pred,
            jnp.int32(self.length), jnp.int32(self.nblocks),
            la_d, lens_d,
        )

    def _pack_ship(self, out, kb, kc, wide=False):
        """Slice the scan outputs to the transfer budgets, fuse into one
        buffer and start the host copy immediately (overlaps the next
        chunk's scan on the device stream)."""
        if self.pair:
            fn = _pack_pair_wide if wide else _pack_pair_compact
            packed = fn(kb, kc, out)
        else:
            counts, idx, data, fidx, frows, subwords = out
            packed = _pack_v3(kb, kc, counts, idx, data, fidx, frows, subwords)
        try:
            packed.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without async copies
            pass
        return packed

    def dispatch(self, seqs, n: int, maxlen: int, min_overlap: int):
        """All orientation lanes of a chunk of (at most n) reads in one
        launch.  maxlen must be a multiple of 16 and > the longest read."""
        la_w, lens = pack_reads_2bit(seqs, n, maxlen)
        la_d, lens_d = self._put(la_w, lens)
        max_t = maxlen - 1
        # scan only as deep as the chunk's real maximum read length (the
        # packed width rounds up to 16 symbols; update steps beyond
        # max(lens)-1 are all-masked).  Bucket to multiples of 8 to bound
        # the number of compiled shapes; for long-sequence chunks (contig
        # re-overlap) the granule widens with maxlen so the distinct
        # (maxlen, lim_t) shape count stays small.  The granules are not
        # yet measured on the H100.
        g = 8 if maxlen <= 2048 else max(8, maxlen // 16)
        lim_t = min(max_t, -(-(int(lens.max()) - 1) // g) * g)
        num_lanes = n * (len(self.fwd_groups) + len(self.rev_groups))
        # fcap = lane count: every lane yields at most one candidate, so the
        # candidate compaction can never overflow
        cap, fcap = self._cap, num_lanes
        if self._kb == 0:
            # first chunk: expect ~6 emitted blocks/read at short-read
            # coverage; sticky growth handles the rest
            self._kb = _granule(6 * n, 8192)
        if self._kc == 0:
            # ~2 containment candidates per read (the ID/REV self matches)
            self._kc = _granule(2 * n + n // 8, 4096)
        kb = min(self._kb, cap)
        kc = min(self._kc, fcap)
        p1 = min(max(min_overlap - 1, 0), lim_t)
        wide = self.pair and (lim_t + 1 - 2 * (p1 // 2)) > 0xFFFF
        out = self._run(cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d)
        packed = self._pack_ship(out, kb, kc, wide=wide)
        return (out, packed, kb, kc, cap, fcap, n, max_t, lim_t, min_overlap,
                la_d, lens_d, wide)

    def collect(self, handle):
        """Fetch one dispatched chunk (normally a single host sync).

        Returns (f_view, r_view), each (lane, t, data4, cand_lanes,
        cand_rows6, substr_flags):
          lane/t/data4: emitted blocks sorted lane-major, t ascending;
            data4 = [lo, hi, rlo, rhi] (hi/rhi from the size invariant);
          cand_lanes: lanes whose full-length '$'-probe is a valid pair
            (containment candidates), ascending;
          cand_rows6: [flo, fhi, frlo, frhi, occ_$(flo-1), occ_$(fhi)] per
            candidate — the probe pair is the closed form
            (l0, u0-1, frlo, frlo+(u0-l0)-1);
          substr_flags: uint8 [lanes] — lext|rext DNA extension of the
            full-length interval (the substring-read test, computed fully
            on device)."""
        (out, packed_d, kb, kc, cap, fcap, n, max_t, lim_t, min_overlap,
         la_d, lens_d, wide) = handle
        packed = np.asarray(packed_d)
        nblocks, fcount = int(packed[0]), int(packed[1])
        while nblocks > cap:
            # scan-side compaction overflowed: re-run with a bigger cap
            cap = _next_pow2(nblocks)
            self._cap = cap
            out = self._run(cap, fcap, max_t, lim_t, min_overlap, la_d, lens_d)
            kb = min(max(kb, _granule(nblocks, 8192)), cap)
            self._kb = max(self._kb, kb)
            packed = np.asarray(self._pack_ship(out, kb, kc, wide=wide))
            nblocks, fcount = int(packed[0]), int(packed[1])
        if self.pair and not wide and (int(packed[2]) or int(packed[3])):
            # a packed 16-bit field overflowed: re-ship in the wide format
            wide = True
            packed = np.asarray(self._pack_ship(out, kb, kc, wide=True))
        if nblocks > kb or fcount > kc:
            # transfer budget too small: re-slice the live outputs
            kb = min(max(kb, _granule(nblocks, 8192)), cap)
            kc = min(max(kc, _granule(fcount, 4096)), fcap)
            self._kb = max(self._kb, kb)
            self._kc = max(self._kc, kc)
            packed = np.asarray(self._pack_ship(out, kb, kc, wide=wide))
        if self.pair:
            return self._decode_pair(
                packed, kb, kc, n, lim_t, min_overlap, wide
            )

        nf, nr = len(self.fwd_groups), len(self.rev_groups)
        num_lanes = n * (nf + nr)
        half = n * nf
        k, fk = kb, kc
        pos = 4 + k
        idx_h = packed[4:pos][:nblocks].astype(np.int64)
        data3 = packed[pos : pos + 3 * k].reshape(3, k)[:, :nblocks]
        pos += 3 * k
        cand_lanes = packed[pos : pos + fk][:fcount].astype(np.int64)
        pos += fk
        cand_rows = np.ascontiguousarray(
            packed[pos : pos + 6 * fk].reshape(6, fk)[:, :fcount].T
        ).astype(np.int64)
        pos += 6 * fk
        subwords_h = packed[pos:].view(np.uint32)
        subbits = (
            (subwords_h[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
        ).astype(np.uint8).reshape(-1)[:num_lanes]

        # reconstruct [lo, hi, rlo, rhi] from [lo, rlo, size]; idx is already
        # lane-major with t ascending (lane*T2 + t - (min_overlap-1))
        data = np.empty((nblocks, 4), dtype=np.int64)
        data[:, 0] = data3[0]
        data[:, 1] = data3[0] + data3[2]
        data[:, 2] = data3[1]
        data[:, 3] = data3[1] + data3[2]
        p1 = min(max(min_overlap - 1, 0), lim_t)
        t2 = lim_t - p1
        if t2 > 0 and nblocks:
            lane = idx_h // t2
            t = idx_h % t2 + p1
        else:
            lane = np.zeros(0, dtype=np.int64)
            t = np.zeros(0, dtype=np.int64)
            data = data[:0]
        # split back into the fwd and rev scanner views
        is_f = lane < half
        cf = cand_lanes < half
        f_view = (lane[is_f], t[is_f], data[is_f],
                  cand_lanes[cf], cand_rows[cf], subbits[:half])
        r_view = (lane[~is_f] - half, t[~is_f], data[~is_f],
                  cand_lanes[~cf] - half, cand_rows[~cf], subbits[half:])
        return f_view, r_view

    def _decode_pair(self, packed, kb, kc, n, lim_t, min_overlap, wide):
        """Decode the pair-scan wire formats into the collect() views."""
        nf, nr = len(self.fwd_groups), len(self.rev_groups)
        num_lanes = n * (nf + nr)
        half = n * nf
        nmask = -(-num_lanes // 32)
        nblocks, fcount = int(packed[0]), int(packed[1])
        p1 = min(max(min_overlap - 1, 0), lim_t)
        t0 = 2 * (p1 // 2)

        pos = 8
        lc_pack = packed[pos : pos + num_lanes // 2].view(np.uint32)
        pos += num_lanes // 2
        lane_counts = np.empty(num_lanes, dtype=np.int64)
        lane_counts[0::2] = lc_pack & 0xFFFF
        lane_counts[1::2] = lc_pack >> 16
        # The 16-bit lane-count halves have no overflow flag (unlike
        # size_ovf/cand_ovf); a lane emitting >65535 blocks would silently
        # corrupt reconstruction.  Unreachable for short reads, so guard it.
        assert int(lane_counts.sum()) == nblocks, (
            "pair-scan lane-count overflow: a lane emitted >65535 blocks"
        )
        if wide:
            data3 = packed[pos : pos + 3 * kb].reshape(3, kb)[:, :nblocks]
            pos += 3 * kb
            lo, rlo, size = (a.astype(np.int64) for a in data3)
            trel = packed[pos : pos + kb][:nblocks].astype(np.int64)
            pos += kb
        else:
            lo = packed[pos : pos + kb][:nblocks].astype(np.int64)
            pos += kb
            rlo = packed[pos : pos + kb][:nblocks].astype(np.int64)
            pos += kb
            szt = packed[pos : pos + kb][:nblocks].view(np.uint32)
            pos += kb
            trel = (szt >> 16).astype(np.int64)
            size = (szt & 0xFFFF).astype(np.int64)
        candmask = packed[pos : pos + nmask].view(np.uint32)
        pos += nmask
        if wide:
            cand5 = packed[pos : pos + 5 * kc].reshape(5, kc)[:, :fcount]
            pos += 5 * kc
            flo, frlo, l0, fsize, psize = (a.astype(np.int64) for a in cand5)
        else:
            flo = packed[pos : pos + kc][:fcount].astype(np.int64)
            pos += kc
            frlo = packed[pos : pos + kc][:fcount].astype(np.int64)
            pos += kc
            l0 = packed[pos : pos + kc][:fcount].astype(np.int64)
            pos += kc
            szpsz = packed[pos : pos + kc][:fcount].view(np.uint32)
            pos += kc
            fsize = (szpsz >> 16).astype(np.int64)
            psize = (szpsz & 0xFFFF).astype(np.int64)
        subwords_h = packed[pos : pos + nmask].view(np.uint32)
        bits = np.arange(32, dtype=np.uint32)[None, :]
        subbits = (
            ((subwords_h[:, None] >> bits) & 1).astype(np.uint8).reshape(-1)
        )[:num_lanes]
        cbits = (
            ((candmask[:, None] >> bits) & 1).astype(bool).reshape(-1)
        )[:num_lanes]
        cand_lanes = np.flatnonzero(cbits)
        assert len(cand_lanes) == fcount

        lane = np.repeat(np.arange(num_lanes, dtype=np.int64), lane_counts)
        t = trel + t0
        data = np.empty((nblocks, 4), dtype=np.int64)
        data[:, 0] = lo
        data[:, 1] = lo + size
        data[:, 2] = rlo
        data[:, 3] = rlo + size
        cand_rows = np.stack(
            [flo, flo + fsize, frlo, frlo + fsize, l0, l0 + psize], axis=1
        )

        is_f = lane < half
        cf = cand_lanes < half
        f_view = (lane[is_f], t[is_f], data[is_f],
                  cand_lanes[cf], cand_rows[cf], subbits[:half])
        r_view = (lane[~is_f] - half, t[~is_f], data[~is_f],
                  cand_lanes[~cf] - half, cand_rows[~cf], subbits[half:])
        return f_view, r_view
