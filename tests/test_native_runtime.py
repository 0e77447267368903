"""Native C++ runtime validation: parity with the spec layer and fixtures.

The runtime (runtime/src/tpulzfse.cpp) is the host-side engine; it must agree
with the spec oracle everywhere. Skipped when the shared library is absent
(run lzfse_rust_tpu/runtime/build.sh).
"""

import hashlib
import pathlib

import numpy as np
import pytest

from lzfse_rust_tpu.runtime import native
from lzfse_rust_tpu.spec import container as spec
from lzfse_rust_tpu.spec.frontend import encode_bytes as spec_encode

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")


def test_native_decode_fixtures(snappy_dir, mutate_dir):
    for p in list(snappy_dir.glob("*.lzfse")) + list(mutate_dir.glob("*.lzfse")):
        want = p.with_suffix(".hash").read_bytes()[:32].hex()
        dec = native.decode_bytes(p.read_bytes())
        assert hashlib.sha256(dec).hexdigest() == want, p.name


def test_native_encode_matches_spec_encoder():
    rng = np.random.default_rng(5)
    cases = [b"", b"x", b"\x00" * 21, b"\x00" * 4097,
             bytes(rng.integers(0, 5, 9000, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
             (b"hello world, " * 3000)]
    for data in cases:
        n_enc = native.encode_bytes(data)
        assert n_enc == spec_encode(data), len(data)
        assert native.decode_bytes(n_enc) == data


def test_native_corpus_roundtrip_size(snappy_dir):
    for name in ["html", "urls.10K"]:
        apple = (snappy_dir / f"{name}.lzfse").read_bytes()
        raw = native.decode_bytes(apple)
        enc = native.encode_bytes(raw)
        assert native.decode_bytes(enc) == raw
        assert len(enc) <= len(apple)
        # cross-engine: spec decodes native output
        assert spec.decode_bytes(enc) == raw


def test_native_rejects_mutations(mutate_dir):
    """Bit-flip battery (tier-2 mutation strategy, test/src/mutate_0.rs):
    every mutated container must decode gracefully — either an error code or
    a successful decode (some flips land in don't-care bits), never a crash.
    """
    from lzfse_rust_tpu.base.errors import DecodeError
    for name in ["raw", "vxn", "vx2", "vx1"]:
        data = bytearray((mutate_dir / f"{name}.lzfse").read_bytes())
        step = max(1, len(data) // 64)  # sample positions for test speed
        for i in range(0, len(data), step):
            for bit in (0, 7):
                data[i] ^= 1 << bit
                try:
                    native.decode_bytes(bytes(data))
                except DecodeError:
                    pass
                data[i] ^= 1 << bit


def test_native_mutation_agreement_with_spec(mutate_dir):
    """Mutated inputs must produce the same accept/reject decision (and the
    same bytes when accepted) as the spec layer."""
    from lzfse_rust_tpu.base.errors import DecodeError
    data = bytearray((mutate_dir / "vx2.lzfse").read_bytes())
    step = max(1, len(data) // 48)
    for i in range(0, len(data), step):
        data[i] ^= 0xFF
        blob = bytes(data)
        try:
            n_out = native.decode_bytes(blob)
            n_err = None
        except DecodeError:
            n_out, n_err = None, True
        try:
            s_out = spec.decode_bytes(blob)
            s_err = None
        except DecodeError:
            s_out, s_err = None, True
        assert (n_err is None) == (s_err is None), f"offset {i}"
        if n_err is None:
            assert n_out == s_out, f"offset {i}"
        data[i] ^= 0xFF


def test_synth_corpus_encode_roundtrip(synth_dir):
    """Encode-roundtrip the synthetic families (word/repl/reps/random).

    Hard size contract: every output <= the reference fixture's size.
    The period-split emission decision (FseBackend::emit_best) closed the
    former reps13/14/15 regressions, so no slack is needed.
    """
    for p in sorted(synth_dir.glob("*.lzfse"))[::5]:  # sample every 5th
        raw = native.decode_bytes(p.read_bytes())
        enc = native.encode_bytes(raw)
        assert native.decode_bytes(enc) == raw, p.name
        assert spec.decode_bytes(enc) == raw, p.name
        assert len(enc) <= p.stat().st_size, p.name


def test_parallel_decode_equivalence(snappy_dir):
    """tl_decode_mt (worker-pool entropy decode + in-order replay) must be
    byte-identical to the sequential engine and agree on accept/reject for
    mutated inputs. Built large enough (>=16 FSE blocks) to actually take
    the parallel path; small inputs route to the sequential engine inside
    tl_decode_mt, covered by every other test via decode_bytes."""
    from lzfse_rust_tpu.base.errors import DecodeError

    raws = [native.decode_bytes(p.read_bytes())
            for p in sorted(snappy_dir.glob("*.lzfse"))]
    big = (b"".join(raws) * 2)[:4_000_000]
    enc = native.encode_bytes(big)
    assert native.decode_bytes(enc, parallel=None) == big
    assert native.decode_bytes(enc, parallel=False) == big

    rng = np.random.default_rng(11)
    blob = bytearray(enc)
    # bit flips across the whole container (headers, payloads, EOS tail)
    # plus truncations: both engines must agree on accept/reject AND bytes
    offsets = sorted(rng.integers(0, len(blob), 60).tolist()) + [
        0, 4, 5, len(blob) - 5, len(blob) - 1]
    for i in offsets:
        blob[i] ^= 0xFF
        m = bytes(blob)
        try:
            a = native.decode_bytes(m, parallel=False)
        except DecodeError:
            a = None
        try:
            b = native.decode_bytes(m)
        except DecodeError:
            b = None
        assert (a is None) == (b is None), f"offset {i}"
        assert a == b, f"offset {i}"
        blob[i] ^= 0xFF
    for cut in (17, len(enc) // 3, len(enc) - 3):
        m = bytes(blob[:cut])
        try:
            a = native.decode_bytes(m, parallel=False)
        except DecodeError:
            a = None
        try:
            b = native.decode_bytes(m)
        except DecodeError:
            b = None
        assert (a is None) == (b is None), f"cut {cut}"
        assert a == b, f"cut {cut}"


_SLOW_FIRST_BLOCK = r"""
import sys
sys.path.insert(0, sys.argv[1])
from lzfse_rust_tpu.runtime import native
from lzfse_rust_tpu.utils import corpus
text = corpus.generate(0, names=["lcet10.txt"])[0][1]
parts = [text[:120000]] + [text[150000 + 5000 * i:][:4200] for i in range(40)]
encs = [native.encode_bytes(p) for p in parts]
container = b"".join(e[:-4] for e in encs) + encs[0][-4:]
want = b"".join(parts)
assert all(native.decode_bytes(container) == want for _ in range(2000))
"""


def test_parallel_decode_slow_first_block():
    """tl_decode_mt with heavy first FSE blocks followed by 40 light ones:
    the light blocks finish while the first still decodes, so the pool
    reaches the first block's slot again (MT_SLOTS later) before it is
    free. That slot must stay busy until decoded; reusing it hung or
    replayed another block's rows. A child process turns a hang into a
    failure."""
    import pathlib
    import subprocess
    import sys
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    subprocess.run([sys.executable, "-c", _SLOW_FIRST_BLOCK, repo],
                   check=True, timeout=120)


def test_parallel_encode_equivalence(snappy_dir):
    """tl_encode_mt (sequential exact frontend + pooled per-block emission)
    must be byte-identical to the sequential engine on single- and
    multi-block inputs, and its output must decode back exactly."""
    rng = np.random.default_rng(23)
    raws = [native.decode_bytes(p.read_bytes())
            for p in sorted(snappy_dir.glob("*.lzfse"))]
    cases = [b"", b"y" * 70000,                      # 1-block boundary sizes
             raws[0], b"".join(raws),                # single + multi block
             (b"".join(raws) * 2)[:3_500_000],
             bytes(rng.integers(0, 256, 200_000, dtype=np.uint8)),  # random
             bytes(rng.integers(0, 3, 500_000, dtype=np.uint8))]    # dense
    for data in cases:
        a = native.encode_bytes(data, parallel=False)
        b = native.encode_bytes(data)
        assert a == b, len(data)
        assert native.decode_bytes(b) == data, len(data)


def test_decode_into_zero_copy(snappy_dir):
    """decode_into (caller-owned buffer, no bytes copy — the pooled
    serving shape) must match decode_bytes on every corpus file and
    reject bad input with the same error."""
    from lzfse_rust_tpu.base.errors import DecodeError

    for p in sorted(snappy_dir.glob("*.lzfse")):
        src = p.read_bytes()
        want = native.decode_bytes(src)
        out = np.empty(native.decode_bound(src), np.uint8)
        n = native.decode_into(src, out, parallel=False)
        assert out[:n].tobytes() == want
        n2 = native.decode_into(src, out)  # mt engine path
        assert n2 == n and out[:n].tobytes() == want
    with pytest.raises(DecodeError):
        native.decode_bound(b"\x00" * 16)
    src = sorted(snappy_dir.glob("*.lzfse"))[0].read_bytes()
    bad = src[:-2]  # truncated EOS
    out = np.empty(native.decode_bound(src), np.uint8)
    with pytest.raises(DecodeError):
        native.decode_into(bad, out, parallel=False)


def test_native_tables_batch_match_xla_builder(snappy_dir):
    """The native batched decode-table builder (the GPU path's tables)
    must emit byte-identical tables to the XLA builder
    (table_build.build_decode_tables) — corpus weights plus degenerate
    shapes (sub-total classes = latch regions, empty classes), written to
    permuted destination rows."""
    jnp = pytest.importorskip("jax.numpy")
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu.ops.table_build import build_decode_tables

    fse: list = []
    paths = sorted(snappy_dir.glob("*.lzfse"))
    assert len(paths) == 12
    for i, p in enumerate(paths):
        M._parse_container(p.read_bytes(), i, fse)
    rows = [d.weights for d in fse]
    # degenerate weight shapes: sub-total classes latch, empty classes
    w = np.zeros(360, np.int64)
    w[0] = 1
    w[20] = 64
    w[40:42] = [100, 50]
    w[104] = 7
    rows.append(w)
    w16 = np.ascontiguousarray(np.stack(rows).astype(np.uint16))
    nb = len(rows)
    v_n = np.zeros((nb, 384), np.int32)
    u_n = np.zeros((nb, 1024), np.int32)
    slots = np.random.default_rng(5).permutation(nb).astype(np.int32)
    native.build_tables_batch(w16, slots, slots, v_n, u_n)
    v_x, _, u_x = build_decode_tables(jnp.asarray(w16.astype(np.int32)))
    assert np.array_equal(v_n[slots], np.asarray(v_x))
    assert np.array_equal(u_n[slots], np.asarray(u_x))
