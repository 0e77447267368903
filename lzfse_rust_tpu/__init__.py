"""lzfse_rust_tpu — an accelerator-batched LZFSE compression framework.

A from-scratch reimplementation of the LZFSE codec (the capabilities of the
`lzfse_rust` crate) designed for GPU execution: batched/blocked data-parallel
kernels in JAX/Pallas for the compute path, a native C++ host runtime for
sequential container assembly and streaming IO, and `jax.sharding` mesh
parallelism for multi-chip scale-out.

Public API (mirrors the reference crate's surface, src/lib.rs:138-142):

    encode_bytes(data)          -> compressed container bytes
    decode_bytes(data)          -> decompressed bytes
    LzfseEncoder / LzfseDecoder -- reusable engine objects (buffer API)
    LzfseRingEncoder / LzfseRingDecoder -- streaming engines
    LzfseWriter / LzfseReader   -- push/pull file-object adapters
    probe(data)                 -> (n_payload_bytes, n_raw_bytes) w/o decode

Engines select the best available backend automatically:
  * "native":  C++ host runtime (fast scalar path)
  * "device":  batched JAX/Pallas kernels (block-parallel path, models/)
  * "spec":    pure numpy/python oracle (always available)
"""

from .api import (LzfseDecoder, LzfseEncoder, LzfseReader, LzfseReaderBytes,
                  LzfseRingDecoder, LzfseRingEncoder, LzfseWriter,
                  LzfseWriterBytes, decode_bytes, decode_many, encode_bytes,
                  encode_many, probe)
from .base.errors import (BadBitStream, BadBlock, DecodeError, FseError,
                          LzfseError, PayloadOverflow, PayloadUnderflow,
                          VnError)

__version__ = "0.1.0"

__all__ = [
    "encode_bytes", "decode_bytes", "encode_many", "decode_many", "probe",
    "LzfseEncoder", "LzfseDecoder", "LzfseRingEncoder", "LzfseRingDecoder",
    "LzfseWriter", "LzfseReader", "LzfseReaderBytes", "LzfseWriterBytes",
    "LzfseError", "DecodeError", "BadBlock", "BadBitStream",
    "PayloadOverflow", "PayloadUnderflow", "FseError", "VnError",
]
