"""Full encode x decode API matrix + corpus size regression.

The reference's ops.rs:6-85 crosses every encode API with every decode API
over shared inputs; here: {one-shot, engine object, ring IO, push writer}
x {one-shot, engine object, ring IO, pull reader}. Also a compression
regression guard: the seeded Snappy-shaped corpus encodes to pinned sizes.
"""

import io

import pytest

import lzfse_rust_tpu as lz


def _encoders():
    def one_shot(data):
        return lz.encode_bytes(data)

    def engine(data):
        return lz.LzfseEncoder().encode_bytes(data)

    def ring_io(data):
        sink = io.BytesIO()
        lz.LzfseRingEncoder().encode(io.BytesIO(data), sink)
        return sink.getvalue()

    def writer(data):
        w = lz.LzfseWriterBytes()
        for i in range(0, max(len(data), 1), 10_007):
            w.write(data[i:i + 10_007])
        return w.into_bytes()

    return [("one_shot", one_shot), ("engine", engine),
            ("ring_io", ring_io), ("writer", writer)]


def _decoders():
    def one_shot(enc):
        return lz.decode_bytes(enc)

    def engine(enc):
        return lz.LzfseDecoder().decode_bytes(enc)

    def ring_io(enc):
        sink = io.BytesIO()
        lz.LzfseRingDecoder().decode(io.BytesIO(enc), sink)
        return sink.getvalue()

    def reader(enc):
        r = lz.LzfseRingDecoder().reader_bytes(enc)
        out = bytearray()
        while True:
            chunk = r.read(8191)
            if not chunk:
                break
            out += chunk
        return bytes(out)

    return [("one_shot", one_shot), ("engine", engine),
            ("ring_io", ring_io), ("reader", reader)]


@pytest.mark.parametrize("size", [0, 1, 21, 4000, 300_000])
def test_encode_decode_matrix(size):
    import numpy as np
    rng = np.random.default_rng(size + 1)
    words = [bytes(rng.integers(97, 123, 7, dtype=np.uint8))
             for _ in range(32)]
    data = b"".join(words[int(i)] for i in
                    rng.integers(0, 32, max(size // 7 + 1, 1)))[:size]
    for ename, efn in _encoders():
        enc = efn(data)
        for dname, dfn in _decoders():
            got = dfn(enc)
            assert got == data, f"{ename} x {dname} ({size}B)"


# Encoded size of each seed-0 corpus source (utils/corpus.generate(0)).
# The corpus is deterministic, so any change in compression moves one of
# these; update the table only for a deliberate change of the encoder.
SEED0_ENCODED = {
    "Mark.Twain-Tom.Sawyer.txt": 6071, "alice29.txt": 54887,
    "asyoulik.txt": 49244, "fireworks.jpeg": 124496,
    "geo.protodata": 17683, "html": 16196, "html_x_4": 16678,
    "kppkn.gtb": 44441, "lcet10.txt": 158605, "paper-100k.pdf": 85723,
    "plrabn12.txt": 182861, "urls.10K": 201012,
}


def test_corpus_size_regression(snappy_dir):
    """Every corpus source encodes through the public API to the fixture's
    bytes, at exactly its pinned size, and round-trips; the seeded
    stand-ins compress like the originals (utils/corpus.REF_SIZE: the
    reference encoder's sizes on the Snappy files) — within 25% per file
    and 5% in total."""
    from lzfse_rust_tpu.utils import corpus
    total_ours = total_ref = 0
    paths = sorted(snappy_dir.glob("*.lzfse"))
    assert len(paths) == len(corpus.NAMES) == len(SEED0_ENCODED)
    for name, raw in corpus.generate(0):
        fixture = (snappy_dir / f"{name}.lzfse").read_bytes()
        ours = lz.encode_bytes(raw)
        assert ours == fixture
        assert len(ours) == SEED0_ENCODED[name], (name, len(ours))
        assert lz.decode_bytes(ours) == raw
        ref = corpus.REF_SIZE[name]
        assert 0.75 <= len(ours) / ref <= 1.25, (name, len(ours), ref)
        total_ours += len(ours)
        total_ref += ref
    assert abs(total_ours / total_ref - 1) < 0.05


@pytest.mark.slow
def test_big_mem_block_guide_roundtrip():
    """>2GB single-buffer encode routes through the sliding-window engine
    (the reference's BLOCK_GUIDE windowing role, frontend_bytes.rs:346-375)
    and round-trips through the streaming decoder (big_mem.rs analog)."""
    import hashlib
    chunk = (b"block-guide windowing exercises the index rebias path! "
             * 1000)  # 55KB compressible tile
    reps = (0x8000_0000 + (55 << 20)) // len(chunk) + 1
    data = chunk * reps
    assert len(data) > 0x7FFFF000
    enc = lz.encode_bytes(data)
    assert len(enc) < len(data) // 8
    # decode through the constant-memory stream, hashing incrementally
    from lzfse_rust_tpu.api import _new_stream_decoder
    dec = _new_stream_decoder()
    h = hashlib.sha256()
    n = 0
    mv = memoryview(enc)
    i = 0
    while i < len(enc):
        i += dec.push(bytes(mv[i:i + (1 << 20)]))
        while True:
            out = dec.pull()
            if not out:
                break
            h.update(out)
            n += len(out)
    while True:
        out = dec.pull()
        if not out:
            break
        h.update(out)
        n += len(out)
    dec.finish()
    assert n == len(data)
    assert h.digest() == hashlib.sha256(data).digest()
