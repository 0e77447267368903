"""Unit tests for the format primitives: constants self-verification, weight
codec, bitstream, headers. Mirrors the reference's tier-1 unit strategy
(src/fse/constants.rs:375-493, weight_encoder.rs:43-51, bits tests).
"""

import numpy as np
import pytest

from lzfse_rust_tpu.base import constants as C
from lzfse_rust_tpu.spec import fse as F
from lzfse_rust_tpu.spec import weights as W
from lzfse_rust_tpu.spec.bits import BitReader, BitWriter
from lzfse_rust_tpu.base.errors import BadBitStream, PayloadUnderflow


def test_constants_l_items():
    base = 0
    for i in range(C.L_SYMBOLS):
        eb = int(C.L_EXTRA_BITS[i])
        assert int(C.L_BASE_VALUE[i]) == base
        for j in range(1 << eb):
            assert int(C.L_BASE_FROM_VALUE[base + j]) == i
        base += 1 << eb
    assert C.MAX_L_VALUE == base - 1
    assert C.MAX_L_BITS == int(C.L_EXTRA_BITS[-1]) + (C.L_STATES.bit_length() - 1)


def test_constants_m_items():
    base = 0
    for i in range(C.M_SYMBOLS):
        eb = int(C.M_EXTRA_BITS[i])
        assert int(C.M_BASE_VALUE[i]) == base
        base += 1 << eb
    assert C.MAX_M_VALUE == base - 1
    assert C.MAX_M_BITS == int(C.M_EXTRA_BITS[-1]) + (C.M_STATES.bit_length() - 1)


def test_constants_d_items():
    base = 0
    for i in range(C.D_SYMBOLS):
        eb = int(C.D_EXTRA_BITS[i])
        assert int(C.D_BASE_VALUE[i]) == base
        idx = C.d_index(np.arange(base, base + (1 << eb)))
        assert (C.D_BASE_FROM_VALUE[idx] == i).all()
        base += 1 << eb
    assert C.MAX_D_VALUE == base - 1
    assert C.MAX_D_BITS == int(C.D_EXTRA_BITS[-1]) + (C.D_STATES.bit_length() - 1)


def test_weight_codec_all_values():
    # Exhaustive encode<->decode for the full representable range, mirroring
    # weight_encoder.rs:43-51.
    for value in range(1048):
        u, u_bits = W.encode_weight(value)
        v, v_bits = W.decode_weight(u)
        assert v == value and u_bits == v_bits


def test_weight_payload_roundtrip():
    rng = np.random.default_rng(7)
    for _ in range(20):
        weights = np.zeros(C.N_WEIGHTS, dtype=np.int64)
        # Build random normalized-ish tables within totals.
        for lo, hi, states in [(0, C.L_TOP, C.L_STATES),
                               (C.L_TOP, C.M_TOP, C.M_STATES),
                               (C.M_TOP, C.D_TOP, C.D_STATES),
                               (C.D_TOP, C.U_TOP, C.U_STATES)]:
            raw = rng.integers(0, 10, hi - lo)
            total = raw.sum()
            if total:
                W.normalize_m1(raw, int(total), states)
            weights[lo:hi] = raw
        payload = W.store_v2(weights)
        back = W.load_v2(payload)
        assert (back == weights).all()
        v1 = W.store_v1(weights)
        assert (W.load_v1(v1) == weights).all()


def test_normalize_m1_exact_total_and_nonzero_preserved():
    rng = np.random.default_rng(3)
    for out_total in (64, 256, 1024):
        for _ in range(50):
            w = rng.integers(0, 5000, 12).astype(np.int64)
            w_orig = w.copy()
            total = int(w.sum())
            if total == 0:
                continue
            W.normalize_m1(w, total, out_total)
            assert int(w.sum()) == out_total
            assert ((w != 0) == (w_orig != 0)).all() or (w >= 0).all()
            # nonzero inputs stay nonzero (weights.rs normalize contract)
            assert (w[w_orig != 0] > 0).all()


def test_bitstream_roundtrip():
    rng = np.random.default_rng(11)
    for trial in range(20):
        n = int(rng.integers(1, 200))
        values = [(int(v), int(b)) for v, b in
                  zip(rng.integers(0, 1 << 15, n), rng.integers(0, 16, n))]
        values = [(v & ((1 << b) - 1), b) for v, b in values]
        wtr = BitWriter()
        for v, b in values:
            wtr.push(v, b)
        payload, off = wtr.finalize()
        assert 0 <= off <= 7
        rdr = BitReader(b"\x00" * 8 + payload, off)
        for v, b in reversed(values):
            assert rdr.pull(b) == v
        rdr.finalize()


def test_bitstream_bad_padding_rejected():
    with pytest.raises(BadBitStream):
        BitReader(b"\xff" * 32, 3)


def test_bitstream_underflow():
    wtr = BitWriter()
    wtr.push(1, 1)
    payload, off = wtr.finalize()
    rdr = BitReader(b"\x00" * 8 + payload, off)
    rdr.pull(1)
    for _ in range(10):
        rdr.pull(20)
    with pytest.raises(PayloadUnderflow):
        rdr.finalize()


def test_v2_header_roundtrip():
    block = F.FseBlock(
        literal=F.LiteralParam(num=40000, n_payload_bytes=12345, bits=3,
                               state=(1, 1023, 512, 7)),
        lmd=F.LmdParam(num=10000, n_payload_bytes=54321, bits=6,
                       state=(63, 1, 255)),
        n_raw_bytes=190000,
    )
    raw = F.store_v2_header(block, 77)
    assert len(raw) == C.V2_HEADER_SIZE
    back, n_weights = F.load_v2_header(raw)
    assert n_weights == 77
    assert back == block


def test_native_table_build_matches_device_build():
    """The native packed-table builder must equal ops/table_build exactly,
    including self-latching entries for invalid totals."""
    import numpy as np
    import pytest as _pytest

    _pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzfse_rust_tpu.ops.table_build import build_decode_tables
    from lzfse_rust_tpu.runtime import native

    if not native.available():
        _pytest.skip("native runtime not built")
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu.utils import corpus
    fse = []
    for _, raw in corpus.generate(0)[:4]:
        M._parse_container(native.encode_bytes(raw), 0, fse)
    assert len(fse) >= 4
    ws = np.stack([d.weights for d in fse]).astype(np.int32)
    rng = np.random.default_rng(3)
    ws = np.concatenate(
        [ws, rng.integers(0, 40, (8, 360)).astype(np.int32)])
    vp, vb, up = build_decode_tables(jnp.asarray(ws))
    v2 = np.zeros((len(ws), 384), np.int32)
    u2 = np.zeros((len(ws), 1024), np.int32)
    for i in range(len(ws)):
        native.build_tables_into(ws[i], v2[i], u2[i])
    assert np.array_equal(np.asarray(vp), v2)
    assert np.array_equal(np.asarray(up), u2)
