"""Distributed (mesh-sharded) suffix-array / BWT construction.

The >HBM index-construction axis (SURVEY §2.9 "index sharding", BASELINE
config 5): no single device ever holds the whole text, its sort state, or
the finished BWT — every big array lives sharded along the mesh's data
axis, and the global suffix sort runs as a BITONIC sort over the device
dimension (log^2 D exchange stages of `ppermute` + local `lax.sort`
merges), the mesh replacement for the reference's in-RAM SA-IS
(/root/reference/3rdparty/sais.hxx) whose working set is strictly
single-node.

Algorithm (same suffix order as index/sa.py::_sa_build_v3 and the host
builders — sentinel '$' ties break by text position):
  1. every device packs its text segment to 2-bit words and derives each
     suffix's 64-symbol seed keys locally, using an 80-symbol halo from the
     next device (one `ppermute`);
  2. one distributed bitonic sort by (4 key words, sentpos, idx) seeds the
     ranks; a halo compare + global exclusive prefix (psum over masked
     device totals) numbers the runs;
  3. prefix-doubling rounds: ranks return to text order with a second
     bitonic sort (keyed by idx), `rank[i+h]` comes from an h-element halo,
     and the round re-sorts by (rank, rank2, idx);
  4. the FINAL sort carries two text-order payloads — the preceding symbol
     codes[i-1] and the read id of position i — so the BWT and the `.sai`
     permutation leave the program already in SA order, packed one int32
     per suffix ((rid << 3) | bwt).  The full SA is never gathered to host
     (the streaming-derivation analog of /root/reference/3rdparty/bcr.c:
     17-40, which also emits BWT runs without materializing the SA).

Capacity: indices are 32-bit, so the text axis caps at 2^31 chars — far
past the 116 Mchar E. coli-scale gate.  Each big array is ~n/D per device.
"""
from __future__ import annotations

import numpy as np

from ..index.sa import _PAD_SYM, GRAM3, _sa_rounds_v3, concat_reads

__all__ = ["distributed_sa", "distributed_index_arrays", "distributed_bwt_perm"]


def _mesh_axis_size(mesh, axis):
    return mesh.shape[axis]


def _bitonic_device_sort(arrs, axis, D, num_keys=None):
    """Global sort of per-device sorted segments over the mesh axis.

    arrs: tuple of int32/uint32 [S] arrays; the first `num_keys` (default
    all) are lexicographic sort keys, the rest ride as payloads.  Every
    sort in this module keys on a globally unique column (text index or
    gpos), so payload placement is deterministic.  Each array must already
    be locally sorted.  Returns the tuple globally sorted: device d holds
    slice [d*S, (d+1)*S).

    Bitonic schedule over the device dimension: every compare-exchange
    step ppermutes the partner's whole segment in, locally sorts the 2S
    concatenation, and keeps the lower or upper half.  Exchange volume is
    S * log2(D)*(log2(D)+1)/2 per device per array."""
    import jax
    import jax.numpy as jnp

    if num_keys is None:
        num_keys = len(arrs)
    logd = D.bit_length() - 1
    assert (1 << logd) == D, "mesh axis size must be a power of two"
    me = jax.lax.axis_index(axis)

    def exchange(ks, partner_of):
        perm = [(d, partner_of(d)) for d in range(D)]
        return tuple(jax.lax.ppermute(k, axis, perm) for k in ks)

    ks = arrs
    for k in range(1, logd + 1):
        for j in range(k - 1, -1, -1):
            # direction of each 2^k block: ascending iff bit k of device id
            # is 0 (final k == logd pass is all-ascending)
            partner = lambda d, jj=j: d ^ (1 << jj)
            other = exchange(ks, partner)
            cat = tuple(jnp.concatenate([a, b]) for a, b in zip(ks, other))
            s = jax.lax.sort(cat, dimension=0, num_keys=num_keys)
            S = ks[0].shape[0]
            if k == logd:
                asc = jnp.bool_(True)
            else:
                asc = ((me >> k) & 1) == 0
            lower_of_pair = (me & (1 << j)) == 0
            take_low = jnp.logical_not(
                jnp.logical_xor(asc, lower_of_pair)
            )
            ks = tuple(jnp.where(take_low, t[:S], t[S:]) for t in s)
    return ks


def _halo_next(x, axis, D, count):
    """First `count` elements of the NEXT device's segment (wraps; the
    wrap source is masked by callers via padding)."""
    import jax

    perm = [((d + 1) % D, d) for d in range(D)]
    return jax.lax.ppermute(x[:count], axis, perm)


def _halo_prev_last(x, axis, D):
    """Last element of the PREVIOUS device's segment (wraps)."""
    import jax

    perm = [(d, (d + 1) % D) for d in range(D)]
    return jax.lax.ppermute(x[-1:], axis, perm)


def _global_exclusive_prefix(total, axis, D):
    """Exclusive prefix sum of a per-device scalar over the mesh axis."""
    import jax
    import jax.numpy as jnp

    me = jax.lax.axis_index(axis)
    all_tot = jax.lax.all_gather(total, axis)
    idx = jnp.arange(D)
    return jnp.sum(jnp.where(idx < me, all_tot, 0))


def _dist_sa_program(rounds, n, D, axis, emit_bwt):
    """shard_map body: codes segment uint8 [S] -> output segment int32 [S].

    emit_bwt=False: output = suffix array (text indices in SA order).
    emit_bwt=True:  output = (rid << 3) | bwt per suffix, SA order — the
    payload-carried BWT/perm derivation (no host SA gather)."""
    import jax
    import jax.numpy as jnp

    S = n // D

    def body(codes_seg):
        me = jax.lax.axis_index(axis)
        base = me * S
        halo = _halo_next(codes_seg, axis, D, 96)
        ext = jnp.concatenate([codes_seg, halo])  # [S+96]
        is_pad = codes_seg == _PAD_SYM
        sym = ext.astype(jnp.int32)
        two = jnp.where(
            sym == 0, 0, jnp.where(sym == _PAD_SYM, 3, sym - 1)
        ).astype(jnp.uint32)
        nw = (S + 96) // 16
        shifts = (30 - 2 * jnp.arange(16, dtype=jnp.uint32))[None, :]
        w16 = (two[: nw * 16].reshape(nw, 16) << shifts).sum(
            axis=1, dtype=jnp.uint32
        )
        pos_local = jnp.arange(S, dtype=jnp.int32)
        # distance to next sentinel within 64 (halo covers it)
        big = jnp.int32(n + 64)
        sent = jnp.where(sym == 0, jnp.arange(S + 96, dtype=jnp.int32), big)
        nxt = jax.lax.associative_scan(jnp.minimum, sent, reverse=True)
        sentpos = jnp.minimum(nxt[:S] - pos_local, 64)
        sentpos = jnp.where(is_pad, 65, sentpos).astype(jnp.int32)

        o = (pos_local & 15).astype(jnp.uint32)
        blk = pos_local // 16
        keys = []
        for j in range(4):
            wa = w16[jnp.clip(blk + j, 0, nw - 1)]
            wb = w16[jnp.clip(blk + j + 1, 0, nw - 1)]
            w = jnp.where(o == 0, wa, (wa << (2 * o)) | (wb >> (32 - 2 * o)))
            vj = jnp.clip(sentpos - 16 * j, 0, 16).astype(jnp.uint32)
            mask = jnp.where(
                vj == 0,
                jnp.uint32(0),
                jnp.uint32(0xFFFFFFFF) << (32 - 2 * jnp.minimum(vj, 16)),
            )
            keys.append(
                jnp.where(is_pad, jnp.uint32(0xFFFFFFFF), w & mask).astype(
                    jnp.int32
                )
            )
        gidx = base + pos_local

        if emit_bwt:
            # text-order payloads, local + one halo element each:
            #   prev = codes[i-1] (0 at global position 0) — bwt char,
            #          sentinels already rank 0;
            #   rid  = #sentinels before i — the read id of position i.
            prev_first = _halo_prev_last(codes_seg.astype(jnp.int32), axis, D)
            prev_first = jnp.where(me == 0, 0, prev_first[0])
            prev = jnp.concatenate(
                [prev_first[None], codes_seg[:-1].astype(jnp.int32)]
            )
            is_sent = (codes_seg == 0).astype(jnp.int32)
            local_cum = jnp.cumsum(is_sent, dtype=jnp.int32)
            rid0 = _global_exclusive_prefix(local_cum[-1], axis, D)
            rid = rid0 + local_cum - is_sent
            payload = ((rid << 3) | prev).astype(jnp.uint32)
        else:
            payload = None

        seed_arrs = tuple(k.astype(jnp.uint32) for k in keys) + (
            sentpos.astype(jnp.uint32),
            gidx.astype(jnp.uint32),
        )
        if emit_bwt and rounds == 0:
            seed_arrs = seed_arrs + (payload,)
        local = jax.lax.sort(seed_arrs, dimension=0, num_keys=6)
        glob = _bitonic_device_sort(local, axis, D, num_keys=6)
        k_s = glob[:4]
        sp_s = glob[4].astype(jnp.int32)
        idx_s = glob[5].astype(jnp.int32)

        if rounds == 0:
            if emit_bwt:
                return glob[6].astype(jnp.int32)
            return idx_s

        # run numbering: compare with the previous element (halo from the
        # previous device = last element ppermuted forward)
        prev_halo = lambda x: _halo_prev_last(x, axis, D)

        changed = sp_s[1:] != sp_s[:-1]
        for k in k_s:
            changed = changed | (k[1:] != k[:-1])
        pv_sp = prev_halo(sp_s)
        pvs = [prev_halo(k) for k in k_s]
        first_diff = (pv_sp != sp_s[:1]).reshape(())
        for pv, k in zip(pvs, k_s):
            first_diff = first_diff | (pv != k[:1]).reshape(())
        first_diff = first_diff | (me == 0)
        # an element starts a run when it differs from its predecessor OR
        # is itself resolved (sentpos != 64); device 0's first element
        # always starts the first run
        boundary = jnp.concatenate(
            [
                jnp.where(first_diff | (sp_s[0] != 64), 1, 0)[None].astype(
                    jnp.int32
                ),
                (changed | (sp_s[1:] != 64)).astype(jnp.int32),
            ]
        )
        local_cum = jnp.cumsum(boundary, dtype=jnp.int32)
        offset = _global_exclusive_prefix(local_cum[-1], axis, D)
        rank_sorted = local_cum + offset - 1

        def unsort(order_key, payload):
            # global sort by text index routes payloads back to text order
            o, p = _bitonic_device_sort(
                (order_key.astype(jnp.uint32), payload.astype(jnp.uint32)),
                axis, D,
            )
            return p.astype(jnp.int32)

        rank = unsort(idx_s, rank_sorted)  # rank in text order, sharded

        def round_fn(r, rank):
            h = GRAM3 << r
            # rank[i+h]: needs an h-element halo from the next device
            halo_r = _halo_next(rank, axis, D, min(h, S))
            ext_r = jnp.concatenate([rank, halo_r])
            gpos = base + pos_local
            key2 = jnp.where(
                gpos + h < n,
                ext_r[jnp.clip(pos_local + h, 0, ext_r.shape[0] - 1)],
                -1,
            )
            loc = jax.lax.sort(
                (
                    rank.astype(jnp.uint32),
                    (key2 + 1).astype(jnp.uint32),
                    gpos.astype(jnp.uint32),
                ),
                dimension=0, num_keys=3,
            )
            r_s, k2_s, i_s = _bitonic_device_sort(loc, axis, D, num_keys=3)
            changed = (r_s[1:] != r_s[:-1]) | (k2_s[1:] != k2_s[:-1])
            fd = (
                (prev_halo(r_s) != r_s[:1]).reshape(())
                | (prev_halo(k2_s) != k2_s[:1]).reshape(())
                | (me == 0)
            )
            boundary = jnp.concatenate(
                [
                    jnp.where(fd, 1, 0)[None].astype(jnp.int32),
                    changed.astype(jnp.int32),
                ]
            )
            local_cum = jnp.cumsum(boundary, dtype=jnp.int32)
            offset = _global_exclusive_prefix(local_cum[-1], axis, D)
            nr = local_cum + offset - 1
            return unsort(i_s.astype(jnp.int32), nr)

        for r in range(rounds - 1):
            rank = round_fn(r, rank)
        # final round: emit the order (and, in emit_bwt mode, route the
        # text-order payload straight into SA order alongside it)
        h = GRAM3 << (rounds - 1)
        halo_r = _halo_next(rank, axis, D, min(h, S))
        ext_r = jnp.concatenate([rank, halo_r])
        gpos = base + pos_local
        key2 = jnp.where(
            gpos + h < n,
            ext_r[jnp.clip(pos_local + h, 0, ext_r.shape[0] - 1)],
            -1,
        )
        final_arrs = (
            rank.astype(jnp.uint32),
            (key2 + 1).astype(jnp.uint32),
            gpos.astype(jnp.uint32),
        )
        if emit_bwt:
            final_arrs = final_arrs + (payload,)
        loc = jax.lax.sort(final_arrs, dimension=0, num_keys=3)
        out = _bitonic_device_sort(loc, axis, D, num_keys=3)
        if emit_bwt:
            return out[3].astype(jnp.int32)
        return out[2].astype(jnp.int32)

    return body


def _run_dist(codes: np.ndarray, mesh, axis: str, emit_bwt: bool):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    D = _mesh_axis_size(mesh, axis)
    n_real = int(codes.size)
    assert n_real < (1 << 31), "32-bit suffix indices cap the text at 2G chars"
    from ..index.sa import _max_span

    rounds = _sa_rounds_v3(_max_span(codes))
    # pad so each device holds an equal segment (pads sort last); segments
    # sized in 128-symbol units so the 2-bit word packing tiles and the
    # doubling halo (up to h=128 for <=256bp reads) fits one neighbor
    S = -(-n_real // D)
    S = max(-(-S // 128) * 128, 128)
    assert S >= (GRAM3 << max(rounds - 1, 0)), "segment smaller than halo"
    n = S * D
    padded = np.full(n, _PAD_SYM, dtype=np.uint8)
    padded[:n_real] = codes

    body = _dist_sa_program(rounds, n, D, axis, emit_bwt)
    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis),
        check_vma=False,
    )
    sharded = jax.device_put(
        jnp.asarray(padded), NamedSharding(mesh, P(axis))
    )
    out = np.asarray(jax.jit(fn)(sharded))
    return out[:n_real] if n > n_real else out


def distributed_sa(codes: np.ndarray, mesh, axis: str = "data") -> np.ndarray:
    """Suffix array of the sentinel-separated rank text, built with every
    large array sharded over `mesh`'s `axis`.  Order identical to
    suffix_array_numpy / the device builder."""
    n_real = int(codes.size)
    if n_real <= 1:
        return np.arange(n_real, dtype=np.int64)
    return _run_dist(codes, mesh, axis, emit_bwt=False).astype(np.int64)


def distributed_bwt_perm(codes: np.ndarray, mesh, axis: str = "data"):
    """(bwt_codes uint8 [n], sai_perm int64 [num_strings]) with the BWT and
    permutation derived ON the mesh (payload carry through the final sort);
    the host only unpacks (rid << 3) | bwt words — the suffix array itself
    is never materialized host-side.

    A whole-read suffix is exactly one whose BWT char is '$' (position 0 or
    preceded by a sentinel), so the `.sai` permutation is the rid payload at
    bwt==0 rows, already in SA order.  Assumes no empty reads (preprocess
    drops them; an empty read would alias its sentinel to a read start)."""
    n_real = int(codes.size)
    if n_real == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    packed = _run_dist(codes, mesh, axis, emit_bwt=True)
    bwt = (packed & 7).astype(np.uint8)
    perm = (packed[bwt == 0] >> 3).astype(np.int64)
    return bwt, perm


def distributed_index_arrays(seqs, mesh, axis: str = "data"):
    """Mesh-sharded (bwt_codes, sai_perm, num_strings) — the distributed
    analog of index/sa.py::build_index_arrays.  BWT/perm derive on-device
    (distributed_bwt_perm); no full-SA host gather."""
    codes, _starts, _lengths = concat_reads(seqs)
    bwt, perm = distributed_bwt_perm(codes, mesh, axis)
    return bwt, perm, len(seqs)
