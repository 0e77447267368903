"""TpuEncoder on the CPU path (device-window match finding in XLA, host
emission) and, through the `gpu_path` fixture, on the GPU path with the
emission kernels interpreted. find_matches_device is pure XLA (row gathers
+ argsort + bounded fori), so it runs anywhere; chip_smoke.py checks the
GPU path's byte identity with the native encoder on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from lzfse_rust_tpu.spec import container as spec
from lzfse_rust_tpu.spec.frontend import encode_bytes as spec_encode


@pytest.fixture(scope="module")
def encoder():
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    return TpuEncoder()


def test_byte_identical_to_spec_small(encoder):
    rng = np.random.default_rng(21)
    cases = [
        b"\x00" * 4097,
        bytes(rng.integers(0, 5, 20000, dtype=np.uint8)),
        (b"the quick brown fox jumps " * 800),
        bytes(rng.integers(0, 256, 8000, dtype=np.uint8)),
    ]
    for data in cases:
        got = encoder.encode_bytes(data)
        assert got == spec_encode(data), len(data)
        assert spec.decode_bytes(got) == data


def test_small_paths_delegate(encoder):
    # <= VN_CUTOFF inputs route through the host LZVN/raw paths
    for data in (b"", b"abc", b"\x00" * 21, b"xy" * 1000):
        assert encoder.encode_bytes(data) == spec_encode(data)


def test_corpus_file(encoder, snappy_dir):
    raw = spec.decode_bytes(
        (snappy_dir / "Mark.Twain-Tom.Sawyer.txt.lzfse").read_bytes())
    got = encoder.encode_bytes(raw)
    assert got == spec_encode(raw)


@pytest.mark.parametrize("vn", [False, True])
def test_device_match_stream_agrees_with_spec(vn):
    """The device candidate pipeline + host arbitration must produce the
    same winning matches as the pure-spec pipeline (both implement the
    reference's FIFO strict-max rule)."""
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.spec.match_find import find_matches

    rng = np.random.default_rng(33)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 7), dtype=np.uint8))
             for _ in range(16)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 16, 700))
    dev = TpuEncoder()._device_matches(data, vn=vn)
    ref = find_matches(data, vn=vn)
    assert dev.pos.tolist() == ref.pos.tolist()
    assert dev.match_pos.tolist() == ref.match_pos.tolist()
    assert dev.fwd_len.tolist() == ref.fwd_len.tolist()
    assert dev.back_max.tolist() == ref.back_max.tolist()


@pytest.mark.slow
def test_multi_window_byte_identity():
    """Inputs beyond one device window must still be byte-identical to the
    one-shot scalar encoder: windows carry a 262144-byte history context and
    selection runs over the full concatenated match stream (the fix for the
    round-1 >1MiB window divergence)."""
    from lzfse_rust_tpu.models.encoder import WINDOW_STRIDE, TpuEncoder
    from lzfse_rust_tpu.spec import frontend as FE

    rng = np.random.default_rng(29)
    words = [bytes(rng.integers(32, 127, int(rng.integers(3, 11)),
                                dtype=np.uint8)) for _ in range(256)]
    data = bytearray()
    while len(data) < WINDOW_STRIDE + 300_000:  # 2 windows + margin
        data += words[int(rng.integers(0, 256))]
    data = bytes(data)
    got = TpuEncoder().encode_bytes(data)
    want = FE.encode_bytes(data)
    assert got == want


def test_encode_many_matches_encode_bytes():
    """The batched serving API must be byte-identical per source to the
    one-shot path (and to the spec encoder), across mixed sizes including
    VN/raw-routed small inputs."""
    from lzfse_rust_tpu.models.encoder import TpuEncoder

    rng = np.random.default_rng(31)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(64)]
    sources = [
        b"",                                           # empty
        b"tiny tiny tiny tiny",                        # VN/raw path
        b" ".join(words[int(i)] for i in rng.integers(0, 64, 900)),
        b" ".join(words[int(i)] for i in rng.integers(0, 64, 4000)),
        bytes(rng.integers(0, 256, 6000, dtype=np.uint8)),  # incompressible
    ]
    enc = TpuEncoder()
    got = enc.encode_many(sources)
    for s, g in zip(sources, got):
        assert g == enc.encode_bytes(s)


def test_staged_serving_path_byte_identity(snappy_dir, gpu_path):
    """The fused native frontend+staging serving path (tl_frontend_stage +
    pooled emission kernels + tl_pack_stage) must be byte-identical to the
    native/spec encoders, including a period-split (emit_best alt-variant)
    source. Kernels run in interpret mode on the CPU backend."""
    from lzfse_rust_tpu.base import constants as C
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.runtime import native

    html = native.decode_bytes((snappy_dir / "html.lzfse").read_bytes())
    rng = np.random.default_rng(7)
    pat = rng.integers(0, 256, 13, dtype=np.uint8).tobytes()
    reps = (pat * (45000 // 13 + 1))[:45000]  # period-13: alt eligible
    srcs = [html[:50000], reps]
    big = [i for i, s in enumerate(srcs) if len(s) > C.VN_CUTOFF]
    enc = TpuEncoder(frontend="native")
    results: list = [None] * len(srcs)
    out = enc._encode_many_staged(srcs, big, results)
    for i in big:
        assert out[i] == native.encode_bytes(srcs[i]), i
    assert enc.last_emission == "device"


def test_grouped_windows_match_sorted_path(monkeypatch):
    """The sort-free grouped window path (native counting-sort grouping +
    no-sort device kernels) must return exactly the argsort path's
    per-window match streams — same sat re-extension set, same winners."""
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.runtime import native

    if not native.available():
        pytest.skip("native runtime not built")

    rng = np.random.default_rng(41)
    words = [bytes(rng.integers(97, 110, int(rng.integers(2, 7)),
                                dtype=np.uint8)) for _ in range(16)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 16, 2500))
    full = np.frombuffer(data, np.uint8)
    enc = TpuEncoder()
    wins = []
    for start in range(0, len(data), 2048):
        base, ctx = max(start - 1024, 0), min(start, 1024)
        n = min(len(data), start + 2048 + 3) - base
        wins.append((0, base, ctx, n, 8192))
    for vn in (False, True):
        got = enc._windows_compact_grouped({0: full}, wins, vn)
        monkeypatch.setenv("LZT_DEV_GROUPED", "0")
        want = enc._windows_compact({0: full}, wins, vn)
        monkeypatch.setenv("LZT_DEV_GROUPED", "1")
        assert got.keys() == want.keys()
        for k in want:
            for a, b in zip(got[k], want[k]):
                assert np.array_equal(a, b), k


def test_staged_serving_batch_byte_identity(snappy_dir, gpu_path):
    """A mixed batch through encode_many on the GPU path: every source of
    the pooled emission pass (blocks of many sources, small sources on the
    host LZVN/raw path, a period-split source) byte-identical to the
    native encoder."""
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.runtime import native

    html = native.decode_bytes((snappy_dir / "html.lzfse").read_bytes())
    alice = native.decode_bytes(
        (snappy_dir / "alice29.txt.lzfse").read_bytes())
    rng = np.random.default_rng(11)
    pat = rng.integers(0, 256, 13, dtype=np.uint8).tobytes()
    reps = (pat * (45000 // 13 + 1))[:45000]  # period-13: alt eligible
    srcs = [html[:50000], alice[:60000], reps, html[:8000], b"tiny",
            alice[:30000]]
    enc = TpuEncoder()
    out = enc.encode_many(srcs)
    assert out == [native.encode_bytes(s) for s in srcs]
    assert enc.last_emission == "device"
