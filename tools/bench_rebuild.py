#!/usr/bin/env python
"""Host-only microbenchmark of the native flatten+LZ-rebuild stage.

Captures the exact arguments decode_many passes to native.flatten_rebuild
(by running the CPU path once over the seeded corpus batch), then times the
native call in isolation — the host rebuild stage of the GPU decode path,
iterated on without a device.

Usage: python tools/bench_rebuild.py [reps=24]
"""
import hashlib
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from lzfse_rust_tpu.runtime import native  # noqa: E402
from lzfse_rust_tpu.utils import corpus  # noqa: E402

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 24


def main():
    raws = [r for _, r in corpus.generate(0)]
    srcs = [native.encode_bytes(r) for r in raws] * REPS

    captured = []
    real = native.flatten_rebuild

    def capture(*a, **k):
        captured.append((a, k))
        return real(*a, **k)

    native.flatten_rebuild = capture
    from lzfse_rust_tpu.models.decoder import TpuDecoder
    dec = TpuDecoder(use_native_rebuild=True)
    stats = {}
    outs = dec.decode_many(srcs, stats=stats)
    native.flatten_rebuild = real
    assert stats.get("fallbacks", 0) == 0, stats
    total = sum(len(o) for o in outs)
    (args, kwargs), = captured

    # verify then time
    hashes = [hashlib.sha256(r).digest() for r in raws] * REPS
    for o, h in zip(outs, hashes):
        assert hashlib.sha256(o).digest() == h

    best = []
    for _ in range(9):
        t0 = time.perf_counter()
        st = real(*args, **kwargs)
        best.append(time.perf_counter() - t0)
    assert all(s >= 0 for s in st)
    t = sorted(best)[1]
    print(f"rebuild: {total / 1e6:.1f} MB in {t * 1e3:.2f} ms "
          f"= {total / t / 1e9:.3f} GB/s  (runs: "
          + " ".join(f"{x * 1e3:.1f}" for x in sorted(best)) + ")")


if __name__ == "__main__":
    main()
