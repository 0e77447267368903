"""The serving batch that chip_smoke.py and bench.py measure, defined once.

Decode: DECODE_REPLICAS copies of the seeded corpus's containers
(utils/corpus; 48 copies = 576 containers, 141 MB raw, 1,728 FSE blocks)
in one TpuDecoder.decode_many call. Encode: ENCODE_REPLICAS copies of its
sources in one TpuEncoder.encode_many call. A time is the wall clock of
one whole call: containers or sources in, host bytes out, so the device
work and the download are complete when it returns. Each measurement is
one warm-up call, then RUNS timed calls whose last output is checked; the
times are kept in run order and the headline is their median.
"""

from __future__ import annotations

import hashlib
import subprocess
import time

DECODE_REPLICAS = 48
ENCODE_REPLICAS = 4
RUNS = 7


class CheckFailed(RuntimeError):
    """A serving call returned wrong bytes or took the wrong path."""


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise CheckFailed(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def batch(seed: int) -> dict:
    """The decode and encode batches of `seed`'s corpus, with what each call
    must return (containers from the native encoder)."""
    from ..runtime import native
    from . import corpus
    srcs = corpus.generate(seed)
    raws = [r for _, r in srcs]
    encs = [native.encode_bytes(r) for r in raws]
    return dict(
        srcs=srcs, raws=raws, encs=encs,
        dec=encs * DECODE_REPLICAS,
        dec_sha=[hashlib.sha256(r).digest() for r in raws] * DECODE_REPLICAS,
        dec_raw=sum(map(len, raws)) * DECODE_REPLICAS,
        enc=raws * ENCODE_REPLICAS,
        enc_want=encs * ENCODE_REPLICAS,
        enc_raw=sum(map(len, raws)) * ENCODE_REPLICAS)


def median(ts: list[float]) -> float:
    return sorted(ts)[len(ts) // 2]


def warm_wall(fn, runs: int = RUNS):
    """(result of the last call, wall seconds of `runs` calls in run order),
    after one warm-up call that compiles."""
    out = fn()
    ts = []
    for _ in range(runs):
        t = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t)
    return out, ts


def check_decode(dec, b: dict, outs: list[bytes], fallbacks: int) -> None:
    if [hashlib.sha256(o).digest() for o in outs] != b["dec_sha"]:
        raise CheckFailed("decoded bytes differ from the sources")
    if fallbacks:
        raise CheckFailed(f"{fallbacks} spec-layer fallbacks")
    if dec.last_path != "gpu":
        raise CheckFailed(f"decoder reports path {dec.last_path!r}")


def time_decode(dec, b: dict):
    """Checked decode of the serving batch. Returns (wall seconds per call
    in run order, mean seconds per timed call of each decode_many stage)."""
    stats: list[dict] = []

    def call():
        stats.append({})
        return dec.decode_many(b["dec"], stats=stats[-1])

    outs, ts = warm_wall(call)
    check_decode(dec, b, outs, sum(s.get("fallbacks", 0) for s in stats))
    stages = {k: sum(s[k] for s in stats[1:]) / len(ts)
              for k, v in stats[-1].items() if isinstance(v, float)}
    return ts, stages


def time_encode(enc, b: dict, runs: int = RUNS) -> list[float]:
    """Checked encode of the serving batch: wall seconds per call."""
    outs, ts = warm_wall(lambda: enc.encode_many(b["enc"]), runs)
    if outs != b["enc_want"]:
        bad = sum(x != y for x, y in zip(outs, b["enc_want"]))
        raise CheckFailed(f"{bad} encodes differ from the native encoder")
    if enc.last_emission != "device":
        raise CheckFailed(f"emission ran on {enc.last_emission!r}")
    return ts
