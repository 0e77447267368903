#!/usr/bin/env python
"""Benchmark: end-to-end batched decode and encode on one GPU.

    python bench.py [--seed N]

Runs the serving batch of lzfse_rust_tpu/utils/serving — the code and the
sizes chip_smoke.py measures: TpuDecoder().decode_many over 48 copies of
the seeded Snappy-shaped corpus (141 MB raw, 1,728 FSE blocks; host parse,
upload, the tANS kernels, download and the native LZ rebuild included) and
TpuEncoder().encode_many over 4 copies, in one process (one process per
card). Every decode output is SHA-256-checked against its source and the
run fails on any spec-layer fallback; every encode is checked byte for
byte against the native encoder.

The last line of standard output is one JSON object: the decode rate on
the median wall clock per call, the card's name and power limit, the JAX
device, every run's seconds, the mean per-stage seconds, and the encode
rate. Without a GPU backend the run fails; it reports no host number in
place of a device one. vs_baseline divides by the reference C library's
decode aggregate on the original Snappy files on the reference README's
i5-2500K (BASELINE.md) — a machine-class anchor only.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

# reference C library decode MB/s per Snappy file (BASELINE.md)
REF_DECODE_MBPS = {
    "html": 816.8, "urls.10K": 475.6, "fireworks.jpeg": 331.9,
    "paper-100k.pdf": 400.8, "html_x_4": 2700.0, "alice29.txt": 309.0,
    "asyoulik.txt": 291.0, "lcet10.txt": 324.2, "plrabn12.txt": 282.1,
    "geo.protodata": 1112.3, "kppkn.gtb": 361.7,
}


def baseline_gbps(sizes: dict) -> float:
    t = sum(sizes[n] / (REF_DECODE_MBPS[n] * 1e6) for n in REF_DECODE_MBPS)
    return sum(sizes[n] for n in REF_DECODE_MBPS) / t / 1e9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from lzfse_rust_tpu.utils import jax_cache
    from lzfse_rust_tpu.utils import serving as S
    jax_cache.enable()
    if jax.default_backend() != "gpu":
        print(f"no GPU backend (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    card = S.card()
    print(card, flush=True)

    from lzfse_rust_tpu.models.decoder import TpuDecoder
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.runtime import native

    b = S.batch(args.seed)
    t_dec, stages = S.time_decode(TpuDecoder(), b)
    t_enc = S.time_encode(TpuEncoder(), b)

    value = b["dec_raw"] / S.median(t_dec) / 1e9
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "corpus_decode_GBps",
        "value": value,
        "unit": "GB/s",
        "vs_baseline": value / baseline_gbps(
            {n: len(r) for n, r in b["srcs"]}),
        "extra": {
            "card": card,
            "device": {"platform": d.platform, "kind": d.device_kind,
                       "count": len(jax.devices())},
            "decode_wall_s": t_dec,
            "raw_bytes": b["dec_raw"],
            "containers": len(b["dec"]),
            "fse_blocks": len(native.walk_batch(b["dec"])[0]),
            "decode_stages_s": stages,
            "encode_GBps": b["enc_raw"] / S.median(t_enc) / 1e9,
            "encode_wall_s": t_enc,
            "encode_raw_bytes": b["enc_raw"],
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
