"""CPU coverage of TpuDecoder's GPU path.

decode_many's GPU path (native walk -> native prep -> tANS kernels ->
fused packed-row rebuild) normally needs a GPU; here the kernels run in
the Pallas interpreter (the `gpu_path` fixture) so the ENTIRE pipeline —
payload packing, table upload, kernel semantics, dense output offsets,
validity checks, VN/RAW source-direct parts, spec fallback — executes
in-suite. chip_smoke.py runs the same path compiled for the card."""

import numpy as np
import pytest


def test_walk_pipeline_interpret(mutate_dir, gpu_path):
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu import api
    from lzfse_rust_tpu.spec import container as spec_container

    fse_src = (mutate_dir / "vx2.lzfse").read_bytes()
    vn_src = api.encode_bytes(b"hello world, hello world, hello")
    raw_src = api.encode_bytes(bytes(np.random.default_rng(3).integers(
        0, 256, 600, dtype=np.uint8)))
    empty_src = b"bvx$"
    bad_src = b"bvx2" + b"\x00" * 40  # malformed: spec fallback must raise

    dec = M.TpuDecoder()
    sources = [fse_src, vn_src, raw_src, empty_src, fse_src]
    stats: dict = {}
    outs = dec.decode_many(sources, stats=stats)
    assert stats.get("fallbacks", 0) == 0
    assert dec.last_path == "gpu"
    for src, out in zip(sources, outs):
        assert bytes(out) == spec_container.decode_bytes(src)

    # malformed containers raise exactly like the Python parse
    with pytest.raises(Exception):
        dec.decode_many([fse_src, bad_src])


def test_walk_pipeline_corpus_and_invalid_streams(snappy_dir, mutate_dir,
                                                  gpu_path):
    """Multi-block corpus containers decode exactly; a container whose FSE
    stream fails the final-state checks is re-decoded by the spec layer
    (counted in stats["fallbacks"]) and raises or agrees exactly."""
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu.base.errors import DecodeError
    from lzfse_rust_tpu.spec import container as spec_container

    srcs = [(snappy_dir / f"{n}.lzfse").read_bytes()
            for n in ("html", "fireworks.jpeg", "geo.protodata")]
    dec = M.TpuDecoder()
    stats: dict = {}
    outs = dec.decode_many(srcs, stats=stats)
    assert stats.get("fallbacks", 0) == 0
    for src, out in zip(srcs, outs):
        assert out == spec_container.decode_bytes(src)

    vx2 = bytearray((mutate_dir / "vx2.lzfse").read_bytes())
    vx2[-20] ^= 0x5A  # inside the L/M/D payload: the stream check fails
    try:
        want = spec_container.decode_bytes(bytes(vx2))
    except DecodeError:
        want = None
    stats = {}
    if want is None:
        with pytest.raises(DecodeError):
            dec.decode_many([bytes(vx2)], stats=stats)
    else:
        assert dec.decode_many([bytes(vx2)], stats=stats) == [want]
    assert stats.get("fallbacks", 0) == 1
