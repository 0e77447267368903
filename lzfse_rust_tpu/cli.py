"""lzfoo-compatible command-line tool.

A clone of the reference's `lzfoo` (lzfoo/main.rs:140-194), which itself
mirrors Apple's `lzfse` tool:

    lzfoo -encode [-i INPUT] [-o OUTPUT] [-v]
    lzfoo -decode [-i INPUT] [-o OUTPUT] [-v]

Streams stdin->stdout when -i/-o are omitted. -v prints ratio, ns/B and MB/s
to stderr (main.rs:111-138 stats).
"""

from __future__ import annotations

import argparse
import sys
import time

from .api import LzfseRingDecoder, LzfseRingEncoder
from .base.errors import LzfseError


def _open_in(path):
    return open(path, "rb") if path else sys.stdin.buffer


def _open_out(path):
    return open(path, "wb") if path else sys.stdout.buffer


def _stats(op: str, n_raw: int, n_payload: int, dt: float) -> None:
    ratio = (n_raw / n_payload) if n_payload else 0.0
    ns_per_b = dt * 1e9 / n_raw if n_raw else 0.0
    mbs = n_raw / dt / 1e6 if dt else 0.0
    sys.stderr.write(
        f"{op}: {n_raw} -> {n_payload} bytes, ratio {ratio:.3f}, "
        f"{ns_per_b:.1f} ns/B, {mbs:.1f} MB/s\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lzfoo", description="LZFSE compress/decompress")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("-encode", action="store_true")
    mode.add_argument("-decode", action="store_true")
    ap.add_argument("-i", metavar="FILE", default=None, help="input file")
    ap.add_argument("-o", metavar="FILE", default=None, help="output file")
    ap.add_argument("-v", action="store_true", help="verbose stats")
    args = ap.parse_args(argv)

    src = _open_in(args.i)
    dst = _open_out(args.o)
    t0 = time.time()
    try:
        if args.encode:
            n_raw, n_payload = LzfseRingEncoder().encode(src, dst)
        else:
            n_payload, n_raw = LzfseRingDecoder().decode(src, dst)
    except LzfseError as e:
        # clean diagnostics, like the reference tool (lzfoo/main.rs error
        # paths) — not a Python traceback
        sys.stderr.write(f"lzfoo: {'encode' if args.encode else 'decode'} "
                         f"failed: {e}\n")
        return 1
    finally:
        if args.i:
            src.close()
        if args.o:
            dst.close()
        else:
            dst.flush()
    if args.v:
        _stats("encode" if args.encode else "decode", n_raw, n_payload,
               time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
