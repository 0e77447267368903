#!/usr/bin/env python
"""Smoke test of the serving path on one GPU.

    python chip_smoke.py [--seed N] [--four-cards]

Phases (any failure exits non-zero before the result line):
  1. environment: JAX version, devices, the card's name and power limit;
     the backend must be "gpu" and the native runtime must build and load;
  2. corpus: the seeded Snappy-shaped corpus (lzfse_rust_tpu/utils/corpus),
     encoded by the native encoder, a subsample checked against the spec
     encoder;
  3. decode: TpuDecoder().decode_many on the serving batch
     (lzfse_rust_tpu/utils/serving: 48 corpus replicas) — every output's
     SHA-256 equals its source's, no spec fallback, the GPU kernel path ran;
     wall clock per call;
  4. encode: TpuEncoder().encode_many on 4 corpus replicas — every output
     byte-identical to the native encoder, emitted on the device;
  5. each tANS kernel against its plain XLA reference at the serving-batch
     shapes: exact agreement; for each alone, the wall clock per
     synchronous call and the GPU time per call from a profiler trace.
With --four-cards only the four-device path runs: the 48-replica decode
through TpuDecoder(mesh=...) compared SHA for SHA with the one-card decode,
and corpus x 4 through TpuEncoder(mesh=...) compared with the native
encoder.

Times are measured as utils/serving describes (bench.py uses the same
code); every line with a number names the card.
The last line of standard output is the result,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import json
import pathlib
import sys

SPEC_CHECK = ("Mark.Twain-Tom.Sawyer.txt", "html", "geo.protodata")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-device decode/encode path")
    args = ap.parse_args()

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    try:
        import lzfse_rust_tpu  # noqa: F401
    except ImportError as e:
        fail(f"package not importable next to chip_smoke.py: {e}")
    import jax

    from lzfse_rust_tpu.utils import jax_cache
    from lzfse_rust_tpu.utils import serving as S
    jax_cache.enable()
    try:
        run(args, jax, S)
    except S.CheckFailed as e:
        fail(str(e))


def run(args, jax, S) -> None:
    # 1. environment
    print(f"jax {jax.__version__}; devices {jax.devices()}", flush=True)
    if jax.default_backend() != "gpu":
        fail(f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    card = S.card()
    print(card, flush=True)
    from lzfse_rust_tpu.runtime import native
    try:
        native.require()
    except native.NativeBuildError as e:
        fail(f"native runtime: {e}")
    n_dev = 4 if args.four_cards else 1
    if len(jax.devices()) < n_dev:
        fail(f"need {n_dev} devices, have {len(jax.devices())}")

    # 2. corpus
    from lzfse_rust_tpu.spec import frontend as spec_fe
    b = S.batch(args.seed)
    for (name, raw), enc in zip(b["srcs"], b["encs"]):
        if name in SPEC_CHECK and spec_fe.encode_bytes(raw) != enc:
            fail(f"native encoder disagrees with the spec encoder on {name}")
    n_raw, n_enc = sum(map(len, b["raws"])), sum(map(len, b["encs"]))
    print(f"corpus seed {args.seed}: {len(b['raws'])} sources, {n_raw} B "
          f"raw, {n_enc} B encoded ({n_raw / n_enc:.3f}:1); spec encoder "
          f"agrees on {len(SPEC_CHECK)}", flush=True)

    from lzfse_rust_tpu.models.decoder import TpuDecoder
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    n_fse = len(native.walk_batch(b["dec"])[0])
    what = (f"{len(b['dec'])} containers, {n_fse} FSE blocks, "
            f"{b['dec_raw']} B raw")

    def rates(ts, n):
        return (f"wall per call median {S.median(ts):.4f} s = "
                f"{n / S.median(ts) / 1e9:.3f} GB/s (runs "
                + ", ".join(f"{t:.4f}" for t in ts) + ")")

    if args.four_cards:
        from lzfse_rust_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(jax.devices()[:4])
        one = TpuDecoder()
        st = {}
        S.check_decode(one, b, one.decode_many(b["dec"], stats=st),
                       st.get("fallbacks", 0))
        dec = TpuDecoder(mesh=mesh)
        ts, _ = S.time_decode(dec, b)
        if dec.last_devices != sorted(d.id for d in mesh.devices.flat):
            fail(f"kernel outputs on devices {dec.last_devices}, "
                 "not on all four")
        print(f"[{card}] four-card decode: {what}; SHA-equal to the "
              f"one-card decode; kernel outputs on devices "
              f"{dec.last_devices}; {rates(ts, b['dec_raw'])}", flush=True)
        enc = TpuEncoder(mesh=mesh)
        ts = S.time_encode(enc, b, runs=1)
        print(f"[{card}] four-card encode ({enc.frontend} frontend): "
              f"{len(b['enc'])} sources byte-identical to native; "
              f"{rates(ts, b['enc_raw'])}", flush=True)
        finish(jax, n_dev)
        return

    # 3. decode
    dec = TpuDecoder()
    ts, stages = S.time_decode(dec, b)
    print(f"[{card}] decode: {what}; all SHA-256 equal, 0 fallbacks, path "
          f"{dec.last_path}; {rates(ts, b['dec_raw'])}; mean stages "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}),
          flush=True)

    # 4. encode
    enc = TpuEncoder()
    ts = S.time_encode(enc, b)
    print(f"[{card}] encode: {len(b['enc'])} sources, {b['enc_raw']} B raw, "
          f"all byte-identical to native, emission {enc.last_emission}; "
          f"{rates(ts, b['enc_raw'])}", flush=True)

    # 5. kernels against the plain XLA reference, serving-batch shapes
    from lzfse_rust_tpu.utils import kernel_check as K
    block = jax.block_until_ready
    case = K.decode_case(b["dec"])
    bad = K.compare_decode(case, block(K.run_decode_kernels(case)),
                           block(K.run_decode_reference(case)))
    if bad:
        fail(f"decode kernels differ from the XLA scans on {bad} blocks")
    print(f"[{card}] decode kernels (literal + L/M/D): {case['nb']} blocks "
          f"exactly equal to the XLA scans", flush=True)
    time_parts(K, S, card, K.decode_parts(case))
    ecase = K.encode_case(b["enc"])
    bad = K.compare_encode(ecase, block(K.run_encode_kernels(ecase)),
                           block(K.run_encode_reference(ecase)))
    if bad:
        fail(f"emission kernels differ from the XLA scans on {bad} blocks")
    print(f"[{card}] emission kernels (literal + L/M/D): {ecase['nb']} "
          f"blocks, packed payloads exactly equal to the XLA scans",
          flush=True)
    time_parts(K, S, card, K.encode_parts(ecase))
    finish(jax, n_dev)


def time_parts(K, S, card: str, parts) -> None:
    """Each kernel or scan alone: wall clock per synchronous call, and GPU
    time per call (kernels and copies on the device's streams) from a
    profiler trace."""
    import jax
    for name, fn in parts:
        _, ts = S.warm_wall(lambda: jax.block_until_ready(fn()))
        try:
            dev = K.device_seconds(fn)
            top = max((k for k in dev if k != "total"), key=dev.get)
            gpu = (f"GPU {dev['total'] * 1e3:.3f} ms in {len(dev) - 1} "
                   f"kernel names, largest {top} {dev[top] * 1e3:.3f} ms")
        except Exception as e:  # the trace is a measurement, not a result
            gpu = f"GPU time not measured ({type(e).__name__}: {e})"
        print(f"[{card}]   {name}: wall median {S.median(ts) * 1e3:.3f} ms "
              f"(min {min(ts) * 1e3:.3f}); {gpu}", flush=True)


def finish(jax, count: int) -> None:
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
