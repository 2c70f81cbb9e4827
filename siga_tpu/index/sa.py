"""Suffix-array construction by batched prefix doubling.

The reference default builder ("sais2",
/root/reference/src/suffix_array_builder.cpp:472-674) suffix-sorts the
concatenation of all reads (ranks $=0<A<C<G<T, one sentinel per read) with
sentinel-vs-sentinel ties broken by text position
(src/suffix_array_builder.cpp:579-592).  That order is identical to the suffix
array of the text where the t-th sentinel is a distinct symbol `t` and base
rank r maps to `S-1+r` (S = number of sentinels): every suffix comparison
resolves at or before the first sentinel, which is unique.

This file implements that order two ways:
  * `suffix_array_numpy` — host prefix doubling via np.lexsort (correctness
    anchor + small-input path);
  * `suffix_array_jax`   — the same algorithm as ~log2(readlen) rounds of
    64-bit key sorts on the device, static shapes, no data-dependent control
    flow beyond a host-side round count.

Both return the suffix array over the concatenated text (dtype int).  The BWT
and the `.sai` permutation are derived in `bwt_from_sa` / `sai_perm_from_sa`:
BWT char = '$' if sa[i]==0 or the preceding char is a sentinel, else the
preceding char (src/suffix_array_builder.cpp:548-553); the `.sai` permutation
keeps whole-read suffixes in SA order (src/suffix_array_builder.cpp:523-531).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core import dna


def concat_reads(seqs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate reads with one sentinel (rank 0) after each.

    Returns (codes, starts, lengths): codes is the rank text (uint8),
    starts[i] the text offset of read i, lengths[i] its length.
    """
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lengths + 1)[:-1]))
    n = int((lengths + 1).sum())
    # one pass over the joined bytes ('$' separators map to rank 0)
    joined = "$".join(seqs) + "$"
    codes = dna.RANK_LUT[np.frombuffer(joined.encode(), dtype=np.uint8)].copy()
    assert codes.size == n
    return codes, starts, lengths


def _pad_size(n_real: int) -> int:
    """Pad the text to a bounded set of shapes: pow2 up to 1M, then multiples
    of pow2/8 (at most 12.5% padding waste, <=8 distinct shapes per octave).
    Pow2 padding above ~64M wasted up to 1.5x HBM during the sort (enough to
    OOM a 90M-char build on one chip)."""
    n = 1024
    while n < n_real and n < (1 << 20):
        n *= 2
    if n_real <= n:
        return n
    step = 1 << 17
    while step * 8 < n_real:
        step *= 2
    return ((n_real + step - 1) // step) * step


def _initial_ranks(codes: np.ndarray) -> np.ndarray:
    """Distinct-sentinel initial ranks: t-th sentinel -> t, base r -> S-1+r."""
    is_sent = codes == 0
    sent_idx = np.cumsum(is_sent) - 1
    s = int(is_sent.sum())
    return np.where(is_sent, sent_idx, (s - 1) + codes.astype(np.int64))


def suffix_array_host(codes: np.ndarray) -> np.ndarray:
    """Best host builder: native C++ seed-sort when available, else the
    numpy seeded build."""
    from .. import native

    if native.available():
        return native.build_sa(codes)
    return suffix_array_numpy_seeded(codes)


def suffix_array_numpy_seeded(codes: np.ndarray) -> np.ndarray:
    """Host gram-seeded suffix sort: the numpy mirror of `_sa_build_v3`.

    One lexsort over (4 x 32-symbol-packed uint32 words, sentinel distance,
    index) ranks every suffix by its first 64 symbols; suffixes whose
    sentinel falls inside the gram are fully resolved, so only pure-base
    64-grams continue into prefix doubling (1 round for <=128bp reads,
    2 for <=256bp).  This is the build path for texts too large for a
    single-device program (the E. coli-scale gate: ~116 Mchar indexes) —
    same order as the device builder and suffix_array_numpy."""
    n = int(codes.size)
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    rounds = _sa_rounds_v3(_max_span(codes))
    pos = np.arange(n, dtype=np.int64)
    sym = codes.astype(np.uint32)
    two = np.where(sym == 0, 0, sym - 1).astype(np.uint32)
    n16 = -(-n // 16)
    two_pad = np.zeros(n16 * 16, dtype=np.uint32)
    two_pad[:n] = two
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))[None, :]
    w16 = (two_pad.reshape(n16, 16) << shifts).sum(axis=1, dtype=np.uint32)
    # distance to the suffix's first sentinel, capped at 64
    sent_pos = np.flatnonzero(codes == 0)
    prev_s = n + 64
    # vectorized "next sentinel at or after i": fill by segments
    nxt_idx = np.zeros(n, dtype=np.int64)
    nxt_idx[sent_pos] = 1
    seg = np.cumsum(nxt_idx[::-1])[::-1]  # sentinels remaining at/after i
    k = len(sent_pos)
    nxt = np.where(seg > 0, sent_pos[k - seg], prev_s)
    sentpos = np.minimum(nxt - pos, 64).astype(np.int64)

    keys = []
    o = (pos & 15).astype(np.uint32)
    blk = pos // 16
    for j in range(4):
        wa = w16[np.minimum(blk + j, n16 - 1)]
        wb = w16[np.minimum(blk + j + 1, n16 - 1)]
        w = np.where(o == 0, wa, (wa << (2 * o)) | (wb >> (32 - 2 * o)))
        vj = np.clip(sentpos - 16 * j, 0, 16).astype(np.uint32)
        mask = np.where(
            vj == 0,
            np.uint32(0),
            (np.uint32(0xFFFFFFFF) << (32 - 2 * np.minimum(vj, 16))).astype(
                np.uint32
            ),
        )
        keys.append(w & mask)
    # lexsort: last key is primary
    order = np.lexsort((pos, sentpos, keys[3], keys[2], keys[1], keys[0]))
    k_s = [k[order] for k in keys]
    sp_s = sentpos[order]
    changed = sp_s[1:] != sp_s[:-1]
    for k in k_s:
        changed = changed | (k[1:] != k[:-1])
    boundary = np.empty(n, dtype=np.int64)
    boundary[0] = 0
    boundary[1:] = (changed | (sp_s[1:] != 64)).astype(np.int64)
    rank_sorted = np.cumsum(boundary)
    if rounds == 0:
        return order
    rank = np.empty(n, dtype=np.int64)
    rank[order] = rank_sorted
    h = GRAM3
    for _ in range(rounds):
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - h] = rank[h:]
        order = np.lexsort((pos, key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        boundary[0] = 0
        boundary[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(
            np.int64
        )
        new_rank = np.cumsum(boundary)
        if new_rank[-1] == n - 1:
            return order
        rank[order] = new_rank
        h *= 2
    return order


def suffix_array_numpy(codes: np.ndarray) -> np.ndarray:
    """Host prefix-doubling suffix array of the sentinel-separated rank text."""
    n = codes.size
    rank = _initial_ranks(codes)
    order = np.argsort(rank, kind="stable")
    if n <= 1:
        return order
    h = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - h] = rank[h:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        boundary = np.empty(n, dtype=np.int64)
        boundary[0] = 0
        boundary[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.cumsum(boundary)
        if new_rank[-1] == n - 1:
            return order
        rank_next = np.empty(n, dtype=np.int64)
        rank_next[order] = new_rank
        rank = rank_next
        h *= 2


def suffix_array_jax(codes: np.ndarray) -> np.ndarray:
    """Device suffix array (gram-seeded batched prefix doubling, B=1)."""
    import jax.numpy as jnp

    n_real = int(codes.size)
    if n_real <= 1:
        return np.arange(n_real, dtype=np.int64)
    rounds = _sa_rounds_v3(_max_span(codes))
    n = _pad_size(n_real)
    order = _sa_build_v3(rounds, n, jnp.asarray(_pad_codes(codes, n)[None, :]))
    out = np.asarray(order[0], dtype=np.int64)
    return out[:n_real] if n > n_real else out


from functools import partial as _partial

_PAD_SYM = 7  # padding symbol, sorts after every real rank
GRAM3 = 64  # v3 seed width: 4 x 16-symbol 2-bit words + a sentinel-pos key


def _sa_rounds_v3(max_span: int) -> int:
    r = 0
    while (GRAM3 << r) < max_span:
        r += 1
    return r


@_partial(__import__("jax").jit, static_argnums=(0, 1))
def _sa_build_v3(rounds, n, codes):
    """64-symbol-gram seeded suffix sort: codes uint8 [B, n] (ranks 0..4,
    pad=_PAD_SYM) -> suffix order int32 [B, n].

    The seed ranks every suffix by its first 64 symbols in ONE sort:
      * 2-bit symbol packing, big-endian within each of 4 uint32 key words
        ($ and A both pack as 0; symbols at/after the suffix's first
        sentinel are zero-masked, so comparisons the reference resolves AT
        a '$' compare equal on the words);
      * the tie between '$' and 'A' at the first divergence is broken by a
        5th key, sentpos = distance to the suffix's first sentinel capped
        at 64 (the suffix whose sentinel comes first is smaller, which is
        exactly '$' < A; equal sentpos with equal words means equal
        prefixes up to the sentinel, where reference '$'-ids break ties by
        text position — the trailing idx key gives exactly that);
      * pad suffixes get sentpos 65 and all-ones words so they sort after
        every real suffix (an all-T real gram ties but wins by idx).
    Suffixes with a sentinel inside the gram (sentpos != 64) are fully
    resolved and take distinct ranks; only pure-base 64-grams continue into
    prefix doubling, so reads up to 128bp need a single doubling round
    (vs 3 with the 16-symbol seed).
    """
    import jax
    import jax.numpy as jnp

    B = codes.shape[0]
    sym = codes.astype(jnp.int32)
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (B, n))
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    is_pad = sym == _PAD_SYM

    two = jnp.where(sym == 0, 0, jnp.where(is_pad, 3, sym - 1)).astype(jnp.uint32)
    shifts = (30 - 2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    w16 = (two.reshape(B, n // 16, 16) << shifts).sum(axis=2, dtype=jnp.uint32)

    big = jnp.int32(n + 64)
    nxt = jax.lax.associative_scan(
        jnp.minimum, jnp.where(sym == 0, pos + jnp.zeros_like(sym), big),
        reverse=True, axis=1,
    )
    sentpos = jnp.minimum(nxt - pos, 64)
    sentpos = jnp.where(is_pad, 65, sentpos).astype(jnp.int32)

    o = (pos & 15).astype(jnp.uint32)
    keys = []
    for j in range(4):
        # Wa[p] = w16[p//16 + j], Wb the following word (wrap garbage at the
        # padded tail is either masked by sentpos or overridden for pads)
        wa = jnp.repeat(jnp.roll(w16, -j, axis=1), 16, axis=1)[:, :n]
        wb = jnp.repeat(jnp.roll(w16, -(j + 1), axis=1), 16, axis=1)[:, :n]
        w = jnp.where(o == 0, wa, (wa << (2 * o)) | (wb >> (32 - 2 * o)))
        vj = jnp.clip(sentpos - 16 * j, 0, 16).astype(jnp.uint32)
        mask = jnp.where(
            vj == 0,
            jnp.uint32(0),
            jnp.uint32(0xFFFFFFFF) << (32 - 2 * jnp.minimum(vj, 16)),
        )
        keys.append(jnp.where(is_pad, jnp.uint32(0xFFFFFFFF), w & mask))

    if n < (1 << 25):
        # pack (sentpos, idx) into one uint32 tail key: 7+25 bits
        key5 = (sentpos.astype(jnp.uint32) << 25) | idx.astype(jnp.uint32)
        sorted_arrs = jax.lax.sort(tuple(keys) + (key5,), dimension=-1, num_keys=5)
        k_s = sorted_arrs[:4]
        sp_s = (sorted_arrs[4] >> 25).astype(jnp.int32)
        idx_s = (sorted_arrs[4] & jnp.uint32((1 << 25) - 1)).astype(jnp.int32)
    else:
        sorted_arrs = jax.lax.sort(
            tuple(keys) + (sentpos, idx), dimension=-1, num_keys=6
        )
        k_s = sorted_arrs[:4]
        sp_s, idx_s = sorted_arrs[4], sorted_arrs[5]
    changed = (sp_s[:, 1:] != sp_s[:, :-1])
    for k in k_s:
        changed = changed | (k[:, 1:] != k[:, :-1])
    boundary = jnp.concatenate(
        [
            jnp.zeros((B, 1), dtype=jnp.int32),
            (changed | (sp_s[:, 1:] != 64)).astype(jnp.int32),
        ],
        axis=-1,
    )
    new_rank = jnp.cumsum(boundary, axis=-1, dtype=jnp.int32)
    if rounds == 0:
        return idx_s

    def unsort(order, payload):
        _, out = jax.lax.sort((order, payload), dimension=-1, num_keys=1)
        return out

    rank = unsort(idx_s, new_rank)

    def round_sort(r, rank):
        h = jnp.asarray(GRAM3, jnp.int32) << r
        key2 = jnp.where(pos + h < n, jnp.roll(rank, -h, axis=-1), -1)
        return jax.lax.sort((rank, key2, idx), dimension=-1, num_keys=2)

    def body(r, rank):
        r_s, k2_s, i_s = round_sort(r, rank)
        b = (r_s[:, 1:] != r_s[:, :-1]) | (k2_s[:, 1:] != k2_s[:, :-1])
        boundary = jnp.concatenate(
            [jnp.zeros((B, 1), dtype=jnp.int32), b.astype(jnp.int32)], axis=-1
        )
        return unsort(i_s, jnp.cumsum(boundary, axis=-1, dtype=jnp.int32))

    rank = jax.lax.fori_loop(0, rounds - 1, body, rank)
    _, _, order = round_sort(rounds - 1, rank)
    return order


def _pad_codes(codes: np.ndarray, n: int) -> np.ndarray:
    out = np.full(n, _PAD_SYM, dtype=np.uint8)
    out[: codes.size] = codes
    return out


def _max_span(codes: np.ndarray) -> int:
    sent_pos = np.flatnonzero(codes == 0)
    prev = np.concatenate(([-1], sent_pos[:-1]))
    return int((sent_pos - prev).max())


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT rank codes in SA order (sentinels collapse to rank 0)."""
    prev = np.where(sa == 0, 0, codes[np.maximum(sa - 1, 0)].astype(np.int64))
    return np.where(sa == 0, 0, prev).astype(np.uint8)


def sai_perm_from_sa(sa: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Read ids of whole-read suffixes, in SA order (the .sai permutation)."""
    n = sa.size
    is_start = np.zeros(n, dtype=bool)
    is_start[starts] = True
    read_of_start = np.zeros(n, dtype=np.int64)
    read_of_start[starts] = np.arange(starts.size)
    mask = is_start[sa]
    return read_of_start[sa[mask]]


@_partial(__import__("jax").jit, static_argnums=(0, 1, 2, 3))
def _sa_bwt_perm_v3(rounds, n, n_real, num_strings, codes4):
    """Suffix sort + BWT/perm derivation in one device program with packed
    host-link IO: the text arrives 4-bit packed (2 chars/byte) and the BWT
    leaves 4-bit packed; only the small perm rides as int32.

    The .sai permutation derives without a searchsorted: a whole-read suffix
    is exactly a position whose BWT char is '$' (sa==0 or codes[sa-1]==0),
    and the read id of text position p is the number of sentinels before p.
    """
    import jax
    import jax.numpy as jnp

    B = codes4.shape[0]
    lo4 = (codes4 & 0xF).astype(jnp.uint8)
    hi4 = (codes4 >> 4).astype(jnp.uint8)
    codes = jnp.stack([lo4, hi4], axis=2).reshape(B, n)
    order = _sa_build_v3(rounds, n, codes)  # [B, n] int32
    sa = order[:, :n_real]
    codes_real = codes[:, :n_real]
    prev = jnp.take_along_axis(codes_real, jnp.clip(sa - 1, 0, n_real - 1), axis=-1)
    bwt = jnp.where(sa == 0, jnp.uint8(0), prev)
    is_sent = (codes_real == 0).astype(jnp.int32)
    rid = jnp.cumsum(is_sent, axis=-1) - is_sent  # read id per text position
    hit = bwt == 0  # exactly num_strings hits per row
    (pos_idx,) = jnp.nonzero(hit.reshape(-1), size=B * num_strings, fill_value=0)
    row = pos_idx // n_real
    sa_at = sa.reshape(-1)[pos_idx]
    perm = rid.reshape(-1)[row * n_real + sa_at].reshape(B, num_strings)
    # 4-bit pack the BWT for the trip home
    half = (n_real + 1) // 2
    bwt_pad = jnp.pad(bwt, ((0, 0), (0, 2 * half - n_real)))
    bwt4 = bwt_pad[:, 0::2] | (bwt_pad[:, 1::2] << 4)
    return bwt4, perm


def _pack4(codes_pad: np.ndarray) -> np.ndarray:
    """Host-side 4-bit text packing (values 0..4 and pad 7; length even)."""
    return codes_pad[..., 0::2] | (codes_pad[..., 1::2] << 4)


def _device_index_build(texts: List[np.ndarray], starts: np.ndarray, num_strings: int):
    """Run the batched device build over B rank texts of equal length."""
    import jax.numpy as jnp

    n_real = int(texts[0].size)
    rounds = max(_sa_rounds_v3(_max_span(c)) for c in texts)
    n = _pad_size(n_real)
    codes4 = _pack4(np.stack([_pad_codes(c, n) for c in texts]))
    bwt4, perm = _sa_bwt_perm_v3(
        rounds, n, n_real, num_strings, jnp.asarray(codes4)
    )
    bwt4 = np.asarray(bwt4)
    perm = np.asarray(perm, dtype=np.int64)
    # host-side 4-bit unpack
    B = bwt4.shape[0]
    bwt = np.empty((B, bwt4.shape[1] * 2), dtype=np.uint8)
    bwt[:, 0::2] = bwt4 & 0xF
    bwt[:, 1::2] = bwt4 >> 4
    bwt = bwt[:, :n_real]
    return [(bwt[b], perm[b]) for b in range(len(texts))]


def _device_max_chars() -> int:
    """Largest text the single-device index program builds; above it the
    seeded host builder takes over.  The 20 Mchar default is not yet
    measured on the H100: the device's memory per char at the sort's peak
    should set it."""
    import os

    return int(os.environ.get("SIGA_SA_DEVICE_MAX", 20_000_000))


def choose_builder(n_chars: int, use_device: bool) -> str:
    """Which suffix sort builds a text of n_chars: "device" (the batched
    prefix-doubling program), "host" (the seeded host build beyond the
    device cap, suffix_array_host) or "numpy" (`siga index -a host`)."""
    if not use_device:
        return "numpy"
    return "device" if n_chars <= _device_max_chars() else "host"


def build_index_arrays(
    seqs: Sequence[str], use_device: bool = False
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Build (bwt_codes, sai_perm, num_strings) for a read set."""
    codes, starts, _lengths = concat_reads(seqs)
    builder = choose_builder(codes.size, use_device)
    if builder == "device":
        (one,) = _device_index_build([codes], starts, len(seqs))
        return one[0], one[1], len(seqs)
    if builder == "host":
        sa = suffix_array_host(codes)
    else:
        sa = suffix_array_numpy(codes)
    return bwt_from_sa(codes, sa), sai_perm_from_sa(sa, starts), len(seqs)


def build_index_arrays_pair(
    seqs: Sequence[str], use_device: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Build forward AND reversed-read indexes in one batched device program
    (the `siga index` product: .sai/.bwt + .rsai/.rbwt, src/indexer.cpp:51-65).

    Returns (fwd_bwt, fwd_perm, rev_bwt, rev_perm, num_strings)."""
    codes, starts, _lengths = concat_reads(seqs)
    rcodes, rstarts, _ = concat_reads([s[::-1] for s in seqs])
    assert np.array_equal(starts, rstarts)
    builder = choose_builder(codes.size, use_device)
    if builder != "device":
        # `-a host`, or beyond the single-device program limit (seeded host
        # build)
        sort = suffix_array_host if builder == "host" else suffix_array_numpy
        sa = sort(codes)
        rsa = sort(rcodes)
        return (
            bwt_from_sa(codes, sa), sai_perm_from_sa(sa, starts),
            bwt_from_sa(rcodes, rsa), sai_perm_from_sa(rsa, starts),
            len(seqs),
        )
    if 2 * codes.size > 21_000_000:
        # big texts: build the two orientations sequentially (B=1) so the
        # sort's peak HBM/compile footprint stays at half the stacked B=2
        (f,) = _device_index_build([codes], starts, len(seqs))
        (r,) = _device_index_build([rcodes], starts, len(seqs))
    else:
        (f, r) = _device_index_build([codes, rcodes], starts, len(seqs))
    return f[0], f[1], r[0], r[1], len(seqs)
