"""Differential encoder fuzz: spec == native ENCODED BYTES on random
generator-driven inputs, plus decode-SHA roundtrips through both engines.

This is the in-process substitute for the reference's lzfse_sys C-oracle
buddy harness (test/src/buddy.rs:63-113): with no liblzfse buildable in
this image, cross-engine byte identity on *arbitrary generated* inputs is
what closes the encode-side oracle gap — the spec encoder equals the
reference's golden vectors on every fixture, so native == spec on fuzzed
inputs extends that equality beyond the fixtures. The device emission
kernels' identity is covered by the interpreted-kernel tests
(tests/test_tans_gpu.py) and on the card by chip_smoke.py.
"""

import hashlib

import numpy as np
import pytest

from lzfse_rust_tpu.spec import container as spec_container
from lzfse_rust_tpu.spec import frontend as FE

try:
    from lzfse_rust_tpu.runtime import native
    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE,
                                reason="native runtime not built")


def _cases():
    """A few hundred deterministic fuzz inputs spanning the encoder's
    regimes: raw (<=20B), LZVN (<=4096B), FSE, block boundaries, masked
    randoms (reference random_0-2.rs), periodic and patchwork data."""
    rng = np.random.default_rng(0xC0DEC)
    cases = []
    # size sweep across the RAW/VN/FSE cutoffs and around power-of-two edges
    for n in (0, 1, 7, 20, 21, 100, 4095, 4096, 4097, 8192, 40000):
        cases.append(rng.integers(0, 256, n, np.uint8) & 0x3F)
    # masked randoms: mask densities shape match/literal mixtures
    for mask in (0x01, 0x03, 0x0F, 0x3F, 0xFF):
        for n in (997, 5000, 30011):
            cases.append(rng.integers(0, 256, n, np.uint8) & mask)
    # short-period repeats (repeat-D / period-split paths)
    for period in (1, 2, 3, 4, 5, 7, 8, 13, 16, 32, 64):
        pat = rng.integers(0, 256, period, np.uint8)
        cases.append(np.tile(pat, 20000 // period + 1)[:20000])
    # patchwork: random self-copies over a random base
    for trial in range(8):
        buf = rng.integers(0, 256, 16384, np.uint8) & 0x1F
        for _ in range(40):
            d = int(rng.integers(1, 8000))
            s = int(rng.integers(d, len(buf) - 64))
            m = int(rng.integers(4, 64))
            buf[s:s + m] = buf[s - d:s - d + m]
        cases.append(buf)
    # word-ish data (dictionary of short tokens)
    words = [rng.integers(97, 123, int(rng.integers(2, 9)), np.uint8)
             for _ in range(60)]
    for n in (3000, 25000):
        picks = rng.integers(0, len(words), n // 4)
        cases.append(np.concatenate([words[p] for p in picks])[:n])
    # random lengths, low-entropy
    for _ in range(200):
        n = int(rng.integers(0, 6000))
        mask = int(rng.choice([0x01, 0x07, 0x1F, 0x7F]))
        cases.append(rng.integers(0, 256, n, np.uint8) & mask)
    return cases


def test_differential_encode_spec_vs_native():
    n_checked = 0
    for arr in _cases():
        src = arr.tobytes()
        want = FE.encode_bytes(src)
        got = native.encode_bytes(src)
        assert got == want, (
            f"native encode differs from spec on len={len(src)} "
            f"sha={hashlib.sha256(src).hexdigest()[:12]}")
        # decode-roundtrip through BOTH engines
        assert native.decode_bytes(got) == src
        assert spec_container.decode_bytes(got) == src
        n_checked += 1
    assert n_checked >= 240
