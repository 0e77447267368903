"""Per-file host benchmark rows over the seeded Snappy-shaped corpus.

Mirrors the reference bench suite's per-file rows (the reference's
bench/src/bench.rs:117-193, stable IDs): encode + decode rates of the native
one-shot engine (`tl_encode`/`tl_decode`) and native streaming (ring), plus
the host serving aggregate (container-parallel decode_into). The sources
are lzfse_rust_tpu/utils/corpus stand-ins for the Snappy files, so the
`ref *` columns (the Apple C library on the reference README's i5-2500K,
measured on the original files) are a machine-class anchor only.

    python tools/bench_corpus.py [--seed N]

Prints a markdown table with the host's CPU count.
"""
import io
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lzfse_rust_tpu import api  # noqa: E402
from lzfse_rust_tpu.runtime import native  # noqa: E402
from lzfse_rust_tpu.utils import corpus  # noqa: E402

SNAPPY_IDS = {  # bench.rs:180-193 tags
    "html": "snap_uflat00_html", "urls.10K": "snap_uflat01_urls",
    "fireworks.jpeg": "snap_uflat02_jpg", "paper-100k.pdf": "snap_uflat04_pdf",
    "html_x_4": "snap_uflat05_html4", "alice29.txt": "snap_uflat06_txt1",
    "asyoulik.txt": "snap_uflat07_txt2", "lcet10.txt": "snap_uflat08_txt3",
    "plrabn12.txt": "snap_uflat09_txt4", "geo.protodata": "snap_uflat10_pb",
    "kppkn.gtb": "snap_uflat11_gaviota",
    "Mark.Twain-Tom.Sawyer.txt": "snap_txt_tom_sawyer",
}

REF_DEC = {"snap_uflat00_html": 816.8, "snap_uflat01_urls": 475.6,
           "snap_uflat02_jpg": 331.9, "snap_uflat04_pdf": 400.8,
           "snap_uflat05_html4": 2700.0, "snap_uflat06_txt1": 309.0,
           "snap_uflat07_txt2": 291.0, "snap_uflat08_txt3": 324.2,
           "snap_uflat09_txt4": 282.1, "snap_uflat10_pb": 1112.3,
           "snap_uflat11_gaviota": 361.7}
REF_ENC = {"snap_uflat00_html": 65.1, "snap_uflat01_urls": 51.3,
           "snap_uflat02_jpg": 55.4, "snap_uflat04_pdf": 57.6,
           "snap_uflat05_html4": 89.7, "snap_uflat06_txt1": 40.4,
           "snap_uflat07_txt2": 38.5, "snap_uflat08_txt3": 42.6,
           "snap_uflat09_txt4": 37.3, "snap_uflat10_pb": 72.1,
           "snap_uflat11_gaviota": 50.2}


def _rate(fn, *args, min_time=0.08, samples=5):
    """2nd-smallest of `samples` ~min_time windows: contention from other
    work on the host only ever ADDS time, so a low-order statistic
    estimates the true cost."""
    fn(*args)  # warm
    reps = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        dt = time.perf_counter() - t0
        if dt >= min_time:
            break
        reps = max(reps * 2, int(reps * min_time / max(dt, 1e-6)))
    vals = [dt / reps]
    for _ in range(samples - 1):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        vals.append((time.perf_counter() - t0) / reps)
    return sorted(vals)[1]


def _ring_decode(enc: bytes) -> int:
    sink = io.BytesIO()
    api.LzfseRingDecoder().decode(io.BytesIO(enc), sink)
    return sink.tell()


def _ring_encode(raw: bytes) -> int:
    sink = io.BytesIO()
    api.LzfseRingEncoder().encode(io.BytesIO(raw), sink)
    return sink.tell()


def row(tag, raw):
    ours = native.encode_bytes(raw)
    assert native.decode_bytes(ours) == raw
    n = len(raw)
    dec_mbs = n / _rate(native.decode_bytes, ours) / 1e6
    enc_mbs = n / _rate(native.encode_bytes, raw) / 1e6
    ring_dec = n / _rate(_ring_decode, ours) / 1e6
    ring_enc = n / _rate(_ring_encode, raw) / 1e6
    return (tag, n, len(ours), dec_mbs, enc_mbs, ring_dec, ring_enc)


def main():
    seed = int(sys.argv[sys.argv.index("--seed") + 1]) \
        if "--seed" in sys.argv else 0
    srcs = corpus.generate(seed)
    lines = [
        f"Seeded corpus (seed {seed}), host native engine, "
        f"{os.cpu_count()} CPUs:",
        "",
        "| id | raw B | ours B | ref B | dec MB/s | ref dec | enc MB/s "
        "| ref enc | ring dec | ring enc |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, raw in srcs:
        tag, n, ours, d, e, rd, re_ = row(SNAPPY_IDS[name], raw)
        lines.append(
            f"| {tag} | {n} | {ours} | {corpus.REF_SIZE[name]} | {d:.0f} | "
            f"{REF_DEC.get(tag, '-')} | {e:.0f} | {REF_ENC.get(tag, '-')} | "
            f"{rd:.0f} | {re_:.0f} |")
    # host serving aggregate: the corpus decoded container-parallel across
    # cores into caller buffers (native.decode_into under a thread pool)
    import concurrent.futures as cf

    import numpy as np
    encs = [native.encode_bytes(r) for _, r in srcs] * 4
    bufs = [np.empty(native.decode_bound(s), np.uint8) for s in encs]
    total = sum(native.decode_into(s, b, parallel=False)
                for s, b in zip(encs, bufs))
    n_threads = min(os.cpu_count() or 1, 8)
    with cf.ThreadPoolExecutor(n_threads) as ex:
        dt = _rate(lambda: list(ex.map(
            lambda sb: native.decode_into(sb[0], sb[1], parallel=False),
            zip(encs, bufs))))
    lines += [
        "",
        f"Host serving aggregate (container-parallel decode_into, "
        f"{n_threads} threads): {total / dt / 1e9:.2f} GB/s",
    ]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
