"""Test configuration and seeded fixtures.

JAX tests run on a virtual 8-device CPU mesh so multi-device sharding is
exercised without accelerator hardware. Tests that need the GPU carry the
`gpu` marker and skip elsewhere (chip_smoke.py runs that path on the card).

Fixture containers are built here from seeds (lzfse_rust_tpu/utils/corpus
and tests/kit.py generators), one directory per family, each container
beside a `.hash` file holding the raw 32-byte SHA-256 of its source:

  snappy/   the Snappy-shaped corpus (12 sources)
  mutate/   one container per block type: raw, vxn, vx1, vx2
  special/  compound (every block type in one container), null (empty
            source), null.vx2 (a Vx2 header claiming no weight payload)
  synth/    the reference bench's synthetic families, small
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import hashlib  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from lzfse_rust_tpu.utils import jax_cache  # noqa: E402

# a persistent jit cache keeps a fresh checkout's suite from recompiling
# every XLA graph and interpreted kernel
jax_cache.enable()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run the slow tier: dense mutation batteries, huge-stream "
             "constant-memory process tests, exhaustive sweeps")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: slow-tier test (runs only with --runslow)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU JAX backend (skipped elsewhere)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's backend is a GPU (decided per
    test, never at import, so every xdist worker collects the same set)."""
    if request.node.get_closest_marker("gpu"):
        import jax
        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU JAX backend")


@pytest.fixture
def gpu_path(monkeypatch):
    """Route TpuDecoder/TpuEncoder onto the GPU path with the tANS kernels
    run by the Pallas interpreter, so the path's host code and the kernel
    logic are tested on the CPU."""
    from lzfse_rust_tpu.ops import tans_gpu
    monkeypatch.setattr(tans_gpu, "INTERPRET", True)
    monkeypatch.setattr(tans_gpu, "select_path",
                        lambda backend=None: "gpu")


def _encoder():
    from lzfse_rust_tpu.runtime import native
    if native.available():
        return native.encode_bytes
    from lzfse_rust_tpu.spec.frontend import encode_bytes
    return encode_bytes


def _vx2_to_vx1(container: bytes) -> bytes:
    """Rewrite every Vx2 block of a container as the equivalent Vx1 block
    (uncompressed u16 weights, block.rs:80-104)."""
    from lzfse_rust_tpu.base import constants as C
    from lzfse_rust_tpu.spec import fse as F
    from lzfse_rust_tpu.spec import weights as W
    out = bytearray()
    pos = 0
    while True:
        magic = int.from_bytes(container[pos:pos + 4], "little")
        if magic != C.MAGIC_VX2:
            assert magic == C.MAGIC_EOS
            return bytes(out + container[pos:])
        block, nw = F.load_v2_header(container[pos:pos + C.V2_HEADER_SIZE])
        w_at = pos + C.V2_HEADER_SIZE
        weights = W.load_v2(container[w_at:w_at + nw])
        n_pay = block.literal.n_payload_bytes + block.lmd.n_payload_bytes
        lit, lmd = block.literal, block.lmd
        u32 = lambda v: (v & 0xFFFFFFFF).to_bytes(4, "little")
        u16 = lambda v: v.to_bytes(2, "little")
        out += (u32(C.MAGIC_VX1) + u32(block.n_raw_bytes) + u32(n_pay)
                + u32(lit.num) + u32(lmd.num) + u32(lit.n_payload_bytes)
                + u32(lmd.n_payload_bytes) + u32(-lit.bits)
                + b"".join(u16(s) for s in lit.state) + u32(-lmd.bits)
                + b"".join(u16(s) for s in lmd.state))
        out += W.store_v1(weights)
        out += container[w_at + nw:w_at + nw + n_pay]
        pos = w_at + nw + n_pay


def _fixture_sources():
    """{family: {name: (source bytes or None, container bytes)}}."""
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from kit import WordSeq
    from lzfse_rust_tpu.base import constants as C
    from lzfse_rust_tpu.utils import corpus

    enc = _encoder()
    rng = np.random.default_rng(2024)
    text = WordSeq(seed=5).read(60000)
    fam = {"snappy": {n: (r, enc(r)) for n, r in corpus.generate(0)}}
    mut = {"raw": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
           "vxn": text[:3000], "vx2": text[:20000]}
    fam["mutate"] = {n: (r, enc(r)) for n, r in mut.items()}
    fam["mutate"]["vx1"] = (mut["vx2"], _vx2_to_vx1(fam["mutate"]["vx2"][1]))
    eos = C.MAGIC_EOS.to_bytes(4, "little")
    parts = [fam["mutate"][n] for n in ("vx2", "vxn", "raw", "vx1")]
    vx2 = fam["mutate"]["vx2"][1]
    nw = (int.from_bytes(vx2[24:28], "little") - C.V2_HEADER_SIZE)
    null_vx2 = (vx2[:24] + C.V2_HEADER_SIZE.to_bytes(4, "little")
                + vx2[28:C.V2_HEADER_SIZE] + vx2[C.V2_HEADER_SIZE + nw:])
    fam["special"] = {
        "compound": (b"".join(r for r, _ in parts),
                     b"".join(c[:-4] for _, c in parts) + eos),
        "null": (b"", enc(b"")),
        "null.vx2": (None, null_vx2),
    }
    synth = {"synth_random": rng.integers(0, 256, 65536,
                                          dtype=np.uint8).tobytes()}
    for n in (1, 4, 13, 16, 64):
        pat = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        synth[f"synth_repl{n:02d}"] = (pat * (65536 // n + 1))[:65536]
    for n in (4, 9, 32):
        words = [rng.integers(97, 123, n, dtype=np.uint8).tobytes()
                 for _ in range(256)]
        pick = rng.integers(0, 256, 65536 // n + 1)
        synth[f"synth_word{n:02d}"] = b"".join(
            words[i] for i in pick)[:65536]
    fam["synth"] = {n: (r, enc(r)) for n, r in synth.items()}
    return fam


@pytest.fixture(scope="session")
def fixture_root(tmp_path_factory) -> pathlib.Path:
    root = tmp_path_factory.mktemp("containers")
    for family, items in _fixture_sources().items():
        d = root / family
        d.mkdir()
        for name, (raw, cont) in items.items():
            (d / f"{name}.lzfse").write_bytes(cont)
            if raw is not None:
                (d / f"{name}.hash").write_bytes(
                    hashlib.sha256(raw).digest())
    return root


@pytest.fixture(scope="session")
def snappy_dir(fixture_root) -> pathlib.Path:
    return fixture_root / "snappy"


@pytest.fixture(scope="session")
def mutate_dir(fixture_root) -> pathlib.Path:
    return fixture_root / "mutate"


@pytest.fixture(scope="session")
def special_dir(fixture_root) -> pathlib.Path:
    return fixture_root / "special"


@pytest.fixture(scope="session")
def synth_dir(fixture_root) -> pathlib.Path:
    return fixture_root / "synth"
