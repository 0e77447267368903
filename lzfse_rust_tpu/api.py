"""Public API objects: buffer engines, streaming engines, IO adapters.

Mirrors the four API shapes of the reference (src/lib.rs:138-142):
one-shot bytes, reusable engine objects, push-style writer, pull-style reader.

Backend selection: the native C++ runtime when built, otherwise the spec
layer. The batched device engines live in `lzfse_rust_tpu.models` and are exposed
via the `tpu_*` functions for explicitly batched workloads.
"""

from __future__ import annotations

import io
from typing import BinaryIO

from .spec import container as _spec_container
from .spec import frontend as _spec_frontend

# Streaming window: matches confined to chunks of this size keep memory
# bounded for unbounded streams, mirroring the ring encoder's 512KB window
# semantics (src/encode/frontend_ring.rs:44-106).
STREAM_CHUNK = 0x80000


def _native():
    """Return the native runtime module or None."""
    try:
        from .runtime import native
        return native if native.available() else None
    except Exception:
        return None


def encode_bytes(src: bytes) -> bytes:
    """One-shot buffer encode (reference: src/encode/mod.rs:58).

    Inputs beyond the 32-bit index range route through the sliding-window
    stream engine — the role of the reference's BLOCK_GUIDE windowing + index
    rebias (frontend_bytes.rs:346-375): window-local coordinates stay small
    while matches keep the full 262139-byte reach across window seams.
    """
    if len(src) > 0x7FFFF000:
        enc = _new_stream_encoder()
        out = []
        mv = memoryview(src)
        for i in range(0, len(src), _IO_CHUNK):
            enc.push(bytes(mv[i:i + _IO_CHUNK]))
            out.append(enc.pull())
        enc.finish()
        while True:
            got = enc.pull()
            if not got:
                break
            out.append(got)
        return b"".join(out)
    n = _native()
    if n is not None:
        return n.encode_bytes(src)
    return _spec_frontend.encode_bytes(src)


def decode_bytes(src: bytes) -> bytes:
    """One-shot buffer decode (reference: src/decode/mod.rs:49)."""
    n = _native()
    if n is not None:
        return n.decode_bytes(src)
    return _spec_container.decode_bytes(src)


def decode_many(sources, max_workers: int | None = None) -> list[bytes]:
    """Decode a batch of independent containers in parallel on the host.

    The native runtime releases the GIL during calls, so a thread pool
    scales across cores; results are byte-identical to sequential decodes.
    (For accelerator-batched decode use models.decoder.TpuDecoder.)
    """
    from concurrent.futures import ThreadPoolExecutor
    sources = list(sources)
    n = _native()
    if len(sources) <= 1 or n is None:
        return [decode_bytes(s) for s in sources]
    # container-level parallelism only: the per-container mt engine would
    # nest its own pool under this one and oversubscribe the cores
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(lambda s: n.decode_bytes(s, parallel=False),
                             sources))


def encode_many(sources, max_workers: int | None = None) -> list[bytes]:
    """Encode a batch of independent buffers in parallel on the host.

    Each output is byte-identical to its sequential encode_bytes result.
    """
    from concurrent.futures import ThreadPoolExecutor
    sources = list(sources)
    n = _native()
    if len(sources) <= 1 or n is None:
        return [encode_bytes(s) for s in sources]

    def one(s):
        if len(s) > 0x7FFFF000:  # BLOCK_GUIDE window route, as encode_bytes
            return encode_bytes(s)
        # sequential engine per container: the emission-parallel engine
        # would nest its own pool under this one
        return n.encode_bytes(s, parallel=False)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, sources))


def probe(src: bytes) -> tuple[int, int]:
    """Return (n_payload_bytes, n_raw_bytes) without decompressing
    (reference: src/decode/probe.rs:11-35)."""
    return _spec_container.probe(src)


class LzfseEncoder:
    """Reusable buffer encoder (reference: LzfseEncoder, encoder.rs:14-58)."""

    def encode_bytes(self, src: bytes) -> bytes:
        return encode_bytes(src)


class LzfseDecoder:
    """Reusable buffer decoder (reference: LzfseDecoder, decoder.rs:17-99)."""

    def decode_bytes(self, src: bytes) -> bytes:
        return decode_bytes(src)


def _new_stream_encoder():
    """Incremental encoder: the native sliding-window engine when built
    (matches cross chunk boundaries up to the 262139-byte Goldilocks reach,
    frontend_ring.rs:44-106), else a window-chunked spec fallback whose
    matches are confined to each 512 KB window."""
    n = _native()
    if n is not None:
        return n.StreamEncoder()
    return _SpecStreamEncoder()


class _SpecStreamEncoder:
    """Window-chunked fallback with the same push/pull/finish protocol."""

    def __init__(self):
        self._buf = bytearray()
        self._out = bytearray()
        self._finished = False

    def push(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= STREAM_CHUNK:
            window = bytes(self._buf[:STREAM_CHUNK])
            del self._buf[:STREAM_CHUNK]
            self._out += _encode_chunk_body(window)
        return len(data)

    def pull(self, cap: int | None = None) -> bytes:
        n = len(self._out) if cap is None else min(cap, len(self._out))
        out = bytes(self._out[:n])
        del self._out[:n]
        return out

    def finish(self) -> None:
        from .base import constants as C
        if self._finished:
            return
        if self._buf:
            self._out += _encode_chunk_body(bytes(self._buf))
            self._buf.clear()
        self._out += C.MAGIC_EOS.to_bytes(4, "little")
        self._finished = True


class LzfseRingEncoder:
    """Streaming encoder over IO objects (reference: LzfseRingEncoder,
    src/encode/ring_encoder.rs).

    Reads `reader` to EOF, encoding incrementally in constant memory.
    With the native engine, matches reach back up to the format's maximum
    distance across chunk boundaries and FSE blocks span chunks — the ring
    encoder's Goldilocks matching. Returns (n_raw_bytes, n_payload_bytes),
    the byte accounting contract of ring_encoder.rs:55-67.
    """

    def writer(self, inner: BinaryIO) -> "LzfseWriter":
        """Push-encoder writing into an IO stream (ring_encoder writer)."""
        return LzfseWriter(inner)

    def writer_bytes(self) -> "LzfseWriterBytes":
        """Push-encoder accumulating into an owned buffer (writer_bytes)."""
        return LzfseWriterBytes()

    def encode(self, reader: BinaryIO, writer: BinaryIO) -> tuple[int, int]:
        enc = _new_stream_encoder()
        n_raw = 0
        n_payload = 0
        while True:
            chunk = reader.read(_IO_CHUNK)
            if not chunk:
                break
            n_raw += len(chunk)
            enc.push(chunk)
            while True:
                out = enc.pull()
                if not out:
                    break
                writer.write(out)
                n_payload += len(out)
        enc.finish()
        while True:
            out = enc.pull()
            if not out:
                break
            writer.write(out)
            n_payload += len(out)
        return n_raw, n_payload


def _encode_chunk_body(data: bytes) -> bytes:
    """Encode one window's blocks without the container EOS."""
    from .base import constants as C
    full = encode_bytes(data)
    assert full[-4:] == C.MAGIC_EOS.to_bytes(4, "little")
    return full[:-4]


def _new_stream_decoder():
    """Constant-memory incremental decoder: native engine when built (O(1)
    state: bounded block carry + 1 MiB output ring), else the spec-layer
    block-granular fallback."""
    n = _native()
    if n is not None:
        return n.StreamDecoder()
    from .spec.streaming import SpecStreamDecoder
    return SpecStreamDecoder()


_IO_CHUNK = 1 << 16


class LzfseRingDecoder:
    """Streaming decoder over IO objects (reference: LzfseRingDecoder,
    src/decode/ring_decoder.rs). Decodes unbounded streams in constant
    memory: input is fed in 64 KB chunks through the incremental stream
    decoder and output drained as it appears — nothing is ever materialized
    whole (reference counterpart: ReaderCore::fill + ring output,
    src/decode/reader_core.rs:56-99)."""

    def decode(self, reader: BinaryIO, writer: BinaryIO) -> tuple[int, int]:
        dec = _new_stream_decoder()
        n_payload = 0
        n_raw = 0
        while True:
            chunk = reader.read(_IO_CHUNK)
            if not chunk:
                break
            n_payload += len(chunk)
            off = 0
            while off < len(chunk):
                off += dec.push(chunk[off:])
                while True:
                    out = dec.pull()
                    if not out:
                        break
                    writer.write(out)
                    n_raw += len(out)
        while True:
            out = dec.pull()
            if not out:
                break
            writer.write(out)
            n_raw += len(out)
        dec.finish()
        return n_payload, n_raw

    def reader(self, inner: BinaryIO) -> "LzfseReader":
        """Wrap an IO stream in a pull-decoder (ring_decoder.rs reader)."""
        return LzfseReader(inner)

    def reader_bytes(self, data: bytes) -> "LzfseReaderBytes":
        """Pull-decoder over an in-memory buffer (reader_bytes)."""
        return LzfseReaderBytes(data)


class LzfseWriter(io.RawIOBase):
    """Push-style compressing writer (reference: LzfseWriter, writer.rs:39-75).

    Bytes written stream through the incremental encoder (cross-chunk
    Goldilocks matching on the native engine); `close()` flushes the final
    block and the EOS magic.
    """

    def __init__(self, inner: BinaryIO):
        super().__init__()
        self._inner = inner
        self._enc = _new_stream_encoder()
        self._finalized = False

    def writable(self) -> bool:
        return True

    def _drain(self) -> None:
        while True:
            out = self._enc.pull()
            if not out:
                break
            self._inner.write(out)

    def write(self, data) -> int:
        self._enc.push(bytes(data))
        self._drain()
        return len(data)

    def close(self) -> None:
        if not self._finalized:
            self._enc.finish()
            self._drain()
            self._finalized = True
        super().close()


class LzfseWriterBytes(LzfseWriter):
    """Push-style writer accumulating into an owned buffer (reference:
    LzfseWriterBytes, writer_bytes.rs:44-78). Call .into_bytes() after
    close()."""

    def __init__(self):
        self._buf_out = io.BytesIO()
        super().__init__(self._buf_out)

    def into_bytes(self) -> bytes:
        if not self.closed:
            self.close()
        return self._buf_out.getvalue()


class LzfseReader(io.RawIOBase):
    """Pull-style decompressing reader (reference: LzfseReader,
    src/decode/reader.rs).

    Truly incremental: each read() pulls only as much as requested from the
    stream decoder, feeding compressed input in 64 KB chunks on demand.
    Memory stays O(1) regardless of stream size (native engine) /
    O(block) (spec fallback) — the whole container is never materialized.
    """

    def __init__(self, inner: BinaryIO):
        super().__init__()
        self._inner = inner
        self._dec = _new_stream_decoder()
        self._buf = bytearray()
        self._in_eof = False
        self._finished = False

    def readable(self) -> bool:
        return True

    def _fill(self, want: int) -> None:
        """Grow the internal buffer to >= want bytes or hit end of stream."""
        while len(self._buf) < want and not self._finished:
            out = self._dec.pull()
            if out:
                self._buf += out
                continue
            if self._in_eof:
                self._dec.finish()  # validates EOS + no truncation
                self._finished = True
                break
            chunk = self._inner.read(_IO_CHUNK)
            if not chunk:
                self._in_eof = True
                continue
            off = 0
            while off < len(chunk):
                used = self._dec.push(chunk[off:])
                off += used
                if off < len(chunk):  # output backpressure: drain
                    out = self._dec.pull()
                    if out:
                        self._buf += out

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            parts = []
            while True:
                self._fill(_IO_CHUNK)
                if not self._buf:
                    break
                parts.append(bytes(self._buf))
                self._buf.clear()
            return b"".join(parts)
        self._fill(size)
        out = bytes(self._buf[:size])
        del self._buf[:size]
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class LzfseReaderBytes(LzfseReader):
    """Pull-style reader over an in-memory buffer (reference:
    LzfseReaderBytes). Decodes incrementally as the caller pulls."""

    def __init__(self, data: bytes):
        super().__init__(io.BytesIO(data))
