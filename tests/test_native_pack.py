"""Native 2-bit read packer (siga_pack_reads_2bit) vs the numpy path."""
import numpy as np
import pytest

from siga_tpu import native
from siga_tpu.ops import fm_device


@pytest.mark.skipif(not native.available(), reason="no native lib")
def test_native_pack_parity_mixed_lengths():
    rng = np.random.default_rng(3)
    A = "ACGT"
    seqs = [
        "".join(A[c] for c in rng.integers(0, 4, int(rng.integers(1, 113))))
        for _ in range(700)
    ]
    seqs.append("")  # empty read -> length clamps to 1
    w_nat, l_nat = fm_device.pack_reads_2bit(seqs, 1024, 112)
    orig = native.available
    native.available = lambda: False
    try:
        w_np, l_np = fm_device.pack_reads_2bit(seqs, 1024, 112)
    finally:
        native.available = orig
    np.testing.assert_array_equal(w_nat, w_np)
    np.testing.assert_array_equal(l_nat, l_np)


@pytest.mark.skipif(not native.available(), reason="no native lib")
def test_native_pack_rejects_non_acgt():
    with pytest.raises(ValueError, match="non-ACGT"):
        fm_device.pack_reads_2bit(["ACGN"], 8, 16)


def _pack_native(seqs, n_rows, maxlen, guard_words=4):
    """Call the C packer directly; returns (rc, words, guard) where guard is
    the region just past the last row."""
    import ctypes

    lib = native.get_lib()
    assert lib is not None, "native library failed to build"
    buf = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    w = maxlen // 16
    out = np.full(n_rows * w + guard_words, 0x7A7A7A7A, dtype=np.int32)
    lens = np.empty(n_rows, dtype=np.int32)
    rc = lib.siga_pack_reads_2bit(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(seqs)),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(maxlen),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return rc, out[: n_rows * w], out[n_rows * w :]


def test_native_pack_refuses_lowercase():
    # the index ranks lowercase bytes as '$', so the packer must not accept
    # them as bases; the checked path then names the error
    rc, _w, _g = _pack_native(["ACGT", "acgt"], 2, 16)
    assert rc == -1
    assert _pack_native(["ACGT", "ACGT"], 2, 16)[0] == 0
    with pytest.raises(ValueError, match="non-ACGT"):
        fm_device.pack_reads_2bit(["ACGT", "acgt"], 2, 16)


def test_native_pack_read_longer_than_maxlen():
    # a read longer than maxlen must not write past its row
    rc, words, guard = _pack_native(["A" * 16, "C" * 40], 2, 16)
    assert rc == -1
    assert (guard == 0x7A7A7A7A).all()
    assert words[0] == 0
    with pytest.raises(ValueError, match="longer than"):
        fm_device.pack_reads_2bit(["A" * 16, "C" * 40], 2, 16)
