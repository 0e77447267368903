"""TpuDecoder on the CPU path (XLA scans + native or XLA LZ rebuild).
The GPU path (tANS kernels) is covered by test_walk_pipeline.py with the
kernels interpreted and by chip_smoke.py on the card."""

import hashlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")


@pytest.fixture(scope="module", params=["native-rebuild", "device-rebuild"])
def decoder(request):
    from lzfse_rust_tpu.models.decoder import TpuDecoder
    return TpuDecoder(use_native_rebuild=request.param == "native-rebuild")


def check(decoder, path):
    src = path.read_bytes()
    out = decoder.decode_bytes(src)
    want = path.with_suffix(".hash").read_bytes()[:32].hex()
    assert hashlib.sha256(out).hexdigest() == want, path.name


def test_mutate_fixtures(decoder, mutate_dir):
    paths = sorted(mutate_dir.glob("*.lzfse"))
    assert [p.name for p in paths] == [
        "raw.lzfse", "vx1.lzfse", "vx2.lzfse", "vxn.lzfse"]
    for p in paths:
        check(decoder, p)
        assert decoder.last_path == ("cpu" if p.stem.startswith("vx")
                                     and p.stem != "vxn" else None)


def test_mixed_container(decoder, special_dir):
    check(decoder, special_dir / "compound.lzfse")


def test_small_corpus_file(decoder, snappy_dir):
    # one FSE-heavy corpus file through the batched pipeline (bigger files
    # are covered on-hardware; CPU-backend scans are slow)
    check(decoder, snappy_dir / "Mark.Twain-Tom.Sawyer.txt.lzfse")


def test_synth_batch(decoder, synth_dir):
    """Every synthetic container in one decode_many call."""
    paths = sorted(synth_dir.glob("*.lzfse"))
    assert len(paths) >= 8
    outs = decoder.decode_many([p.read_bytes() for p in paths])
    for p, out in zip(paths, outs):
        want = p.with_suffix(".hash").read_bytes()
        assert hashlib.sha256(out).digest() == want, p.name


def test_batch_many(decoder, mutate_dir, special_dir):
    srcs = [(mutate_dir / f"{n}.lzfse").read_bytes()
            for n in ["raw", "vxn", "vx2"]]
    srcs.append((special_dir / "compound.lzfse").read_bytes())
    from lzfse_rust_tpu.spec import container as spec
    outs = decoder.decode_many(srcs)
    for src, out in zip(srcs, outs):
        assert out == spec.decode_bytes(src)


def test_fallback_on_malformed(decoder, mutate_dir):
    from lzfse_rust_tpu.base.errors import DecodeError
    data = bytearray((mutate_dir / "vx2.lzfse").read_bytes())
    data[40] ^= 0xFF  # corrupt inside the weight payload
    from lzfse_rust_tpu.spec import container as spec
    try:
        want = spec.decode_bytes(bytes(data))
        err = None
    except DecodeError as e:
        want, err = None, e
    if err is None:
        assert decoder.decode_bytes(bytes(data)) == want
    else:
        with pytest.raises(DecodeError):
            decoder.decode_bytes(bytes(data))


def test_lz_rebuild_overlap_semantics():
    """Self-extending overlapped matches (distance < length) resolve like the
    byte-serial reference copy (lz/object.rs:60-74)."""
    import jax.numpy as jnp
    from lzfse_rust_tpu.ops.lz_rebuild import lz_rebuild_batch
    lits = np.zeros((1, 8), np.uint8)
    lits[0, :3] = [7, 8, 9]
    rows = np.array([[[3, 0, 0], [0, 13, 2]]], np.int32)  # abc + 13 @ d=2
    out, ok = lz_rebuild_batch(jnp.asarray(lits), jnp.asarray(rows),
                               jnp.asarray(np.array([16], np.int32)), 16)
    assert bool(np.asarray(ok)[0])
    want = bytearray([7, 8, 9])
    for _ in range(13):
        want.append(want[-2])
    assert np.asarray(out)[0].tolist() == list(want)


def test_lz_rebuild_rejects_bad_distance():
    import jax.numpy as jnp
    from lzfse_rust_tpu.ops.lz_rebuild import lz_rebuild_batch
    lits = np.zeros((1, 8), np.uint8)
    rows = np.array([[[2, 5, 3]]], np.int32)  # d=3 > produced 2 bytes
    _, ok = lz_rebuild_batch(jnp.asarray(lits), jnp.asarray(rows),
                             jnp.asarray(np.array([7], np.int32)), 8)
    assert not bool(np.asarray(ok)[0])
