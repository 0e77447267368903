"""Native batch container walk vs the Python parse — acceptance and
descriptor parity.

The GPU decode path trusts `tl_walk_batch` for parsing; these tests
pin it to the Python `_parse_container` oracle: identical descriptor
fields on the corpus, and identical accept/reject decisions under
single-bit mutations (the walk may never accept what Python rejects —
rejected containers re-parse through Python for exact error semantics)."""

import random

import numpy as np
import pytest

import lzfse_rust_tpu.models.decoder as M


def _native():
    n = M._native_mod()
    if n is None:
        pytest.skip("native runtime not built")
    return n


def test_walk_descriptor_parity_corpus(snappy_dir):
    native = _native()
    srcs = [p.read_bytes() for p in sorted(snappy_dir.glob("*.lzfse"))]
    assert len(srcs) == 12
    from lzfse_rust_tpu import api
    srcs.append(api.encode_bytes(b"hello world, hello world, hello"))
    srcs.append(api.encode_bytes(bytes(range(256)) * 2))
    srcs.append(b"bvx$")  # empty container
    desc, w16, parts, cpo, nraw, ok = native.walk_batch(srcs)
    for ci, s in enumerate(srcs):
        fse: list = []
        pc = M._parse_container(s, ci, fse)
        assert ok[ci] == 1
        assert nraw[ci] == pc.n_raw
        sub = parts[cpo[ci]:cpo[ci + 1]]
        assert len(sub) == len(pc.parts)
        for k, part in enumerate(pc.parts):
            P = sub[k]
            if part[0] == "fse":
                d = fse[part[1]]
                assert P[0] == 0
                D = desc[P[1]]
                assert D[0] == ci
                assert (D[1], D[2]) == (d.block.literal.num, d.block.lmd.num)
                assert (D[3], D[4]) == (d.block.literal.bits, d.block.lmd.bits)
                assert D[6] == len(d.lit_payload)
                assert D[8] == len(d.lmd_payload)
                assert s[D[5]:D[5] + D[6]] == d.lit_payload
                assert s[D[7]:D[7] + D[8]] == d.lmd_payload
                assert tuple(D[9:13]) == tuple(d.block.literal.state)
                assert tuple(D[13:16]) == tuple(d.block.lmd.state)
                assert D[16] == d.block.n_raw_bytes
                assert np.array_equal(
                    np.asarray(w16[P[1]], np.int64),
                    d.weights.astype(np.int64))
                assert (P[2], P[3]) == (d.block.lmd.num, d.block.literal.num)
            else:
                assert P[0] in (2, 3)


def test_walk_mutation_acceptance_agreement(snappy_dir):
    native = _native()
    base = sorted(snappy_dir.glob("*.lzfse"))[0].read_bytes()
    rng = random.Random(7)
    agree = 0
    n_trials = 200
    for _ in range(n_trials):
        b = bytearray(base)
        pos = rng.randrange(len(b))
        b[pos] ^= 1 << rng.randrange(8)
        mb = bytes(b)
        try:
            M._parse_container(mb, 0, [])
            py_ok = True
        except Exception:
            py_ok = False
        w_ok = bool(native.walk_batch([mb])[5][0])
        # the walk must never be LOOSER than the Python parse; stricter is
        # tolerated (those containers re-parse through Python)
        assert not (w_ok and not py_ok), pos
        agree += w_ok == py_ok
    assert agree == n_trials  # currently exact agreement; tighten if it drifts


def test_walk_truncation_and_garbage(snappy_dir):
    native = _native()
    base = sorted(snappy_dir.glob("*.lzfse"))[0].read_bytes()
    for bad in (base[:100], base[:-1], base + b"x", b"", b"nope"):
        assert native.walk_batch([bad])[5][0] == 0
