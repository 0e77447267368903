"""Mesh-sharded pipeline tests on the virtual 8-device CPU mesh.

Exercises the data-parallel block sharding, container-parallel rebuild and
the ordered all-gather epilogue (SURVEY.md §2.3 capabilities) end-to-end
against the spec oracle. The driver's dryrun_multichip covers the same path
standalone; this keeps it in the regression suite.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")


@pytest.fixture(scope="module")
def vx2(mutate_dir) -> bytes:
    """A one-FSE-block container (seeded, tests/conftest.py)."""
    return (mutate_dir / "vx2.lzfse").read_bytes()


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device (virtual CPU) mesh")
    from lzfse_rust_tpu.parallel.mesh import make_mesh
    return make_mesh(jax.devices()[:4])


def _arrays(src: bytes, B: int):
    import lzfse_rust_tpu.models.decoder as M
    fse_blocks = []
    M._parse_container(src, 0, fse_blocks)
    d = fse_blocks[0]
    lit = np.zeros((B, M.LIT_PAYLOAD_PAD + M._PAD_TAIL), np.uint8)
    lmd = np.zeros((B, M.LMD_PAYLOAD_PAD + M._PAD_TAIL), np.uint8)
    lit[:, :len(d.lit_payload)] = np.frombuffer(d.lit_payload, np.uint8)
    lmd[:, :len(d.lmd_payload)] = np.frombuffer(d.lmd_payload, np.uint8)
    ls = d.block.lmd.state
    return dict(
        weights=np.tile(d.weights.astype(np.int32), (B, 1)),
        lit_payload=lit, lmd_payload=lmd,
        lit_states=np.tile(np.array(d.block.literal.state, np.int32), (B, 1)),
        lit_pos=np.full(B, len(d.lit_payload) * 8 - d.block.literal.bits,
                        np.int32),
        lit_num=np.full(B, d.block.literal.num, np.int32),
        lmd_states=np.tile(np.array((ls[0], ls[1] + 64, ls[2] + 128),
                                    np.int32), (B, 1)),
        lmd_pos=np.full(B, len(d.lmd_payload) * 8 - d.block.lmd.bits,
                        np.int32),
        lmd_num=np.full(B, d.block.lmd.num, np.int32),
    ), d


def test_sharded_pipeline_matches_oracle(mesh, vx2):
    from lzfse_rust_tpu.parallel.mesh import (gather_compressed,
                                              sharded_entropy_decode,
                                              sharded_rebuild)
    from lzfse_rust_tpu.spec import container as spec

    B = 8
    arrays, d = _arrays(vx2, B)
    literals, lmds, ok = sharded_entropy_decode(
        mesh, arrays, n_lit_steps=(d.block.literal.num + 3) // 4,
        n_lmd_steps=d.block.lmd.num)
    assert np.asarray(ok).all()

    nl = d.block.lmd.num
    rows = np.asarray(lmds)[:, :nl]
    consumed = int(rows[0, :, 0].sum())
    out, rok = sharded_rebuild(
        mesh, np.asarray(literals)[:, :max(consumed, 1)], rows,
        np.full(B, d.block.n_raw_bytes, np.int32),
        n_out=(d.block.n_raw_bytes + 4095) // 4096 * 4096)
    assert np.asarray(rok).all()
    want = spec.decode_bytes(vx2)
    for b in range(B):
        assert np.asarray(out)[b, :d.block.n_raw_bytes].tobytes() == want

    import jax.numpy as jnp
    blocks = np.arange(B * 16, dtype=np.uint8).reshape(B, 16)
    lens = np.arange(B, dtype=np.int32)
    g_blocks, g_lens = gather_compressed(mesh, jnp.asarray(blocks),
                                         jnp.asarray(lens))
    assert (np.asarray(g_blocks) == blocks).all()
    assert (np.asarray(g_lens) == lens).all()


def test_sharded_tans_kernels_match_unsharded(mesh, snappy_dir):
    """The GPU tANS kernels under shard_map (one slice of the blocks per
    device, parallel/mesh.sharded_tans_decode) must produce exactly the
    unsharded kernels' outputs; kernels interpreted on the virtual CPU
    mesh."""
    from lzfse_rust_tpu.parallel.mesh import sharded_tans_decode
    from lzfse_rust_tpu.utils import kernel_check as K

    src = (snappy_dir / "Mark.Twain-Tom.Sawyer.txt.lzfse").read_bytes()
    case = K.decode_case([src] * 4)  # one FSE block per container
    want = [np.asarray(x) for x in K.run_decode_kernels(case, True)]
    host = tuple(np.stack([case[k]] * 4) for k in
                 ("u_tab", "v_tab", "words", "small"))
    got = sharded_tans_decode(mesh, host, case["n_lit"], case["n_lmd"],
                              interpret=True)
    assert {d.id for d in got[0].devices()} == {
        d.id for d in mesh.devices.flat}
    for g, w in zip(got, want):
        for k in range(4):
            assert np.array_equal(np.asarray(g)[k], w)


def test_tpu_decoder_mesh_end_to_end(mesh, vx2, gpu_path):
    """TpuDecoder(mesh=...) serving path: container-in -> bytes-out with
    the block batch sharded across the mesh (GPU kernels under shard_map,
    interpreted) — the composed multi-device capability, not just its
    stages. Byte-checked against the spec oracle."""
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu import api
    from lzfse_rust_tpu.spec import container as spec_container

    native = M._native_mod()
    if native is None:
        pytest.skip("native runtime not built")

    vn_src = api.encode_bytes(b"mesh serving, mesh serving, mesh serving!")
    dec = M.TpuDecoder(mesh=mesh)
    sources = [vx2, vn_src, vx2, vx2, vx2]
    stats: dict = {}
    outs = dec.decode_many(sources, stats=stats)
    assert stats.get("fallbacks", 0) == 0
    assert dec.last_path == "gpu"
    assert dec.last_devices == sorted(d.id for d in mesh.devices.flat)
    for src, out in zip(sources, outs):
        assert bytes(out) == spec_container.decode_bytes(src)


def test_tpu_encoder_mesh_end_to_end(mesh):
    """TpuEncoder(mesh=...): the device-frontend window batch shards
    across the mesh (sort-free grouped kernels under shard_map) and the
    encode output stays byte-identical to the spec encoder."""
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.spec.frontend import encode_bytes as spec_encode

    if M._native_mod() is None:
        pytest.skip("native runtime not built")

    rng = np.random.default_rng(43)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(64)]
    sources = [
        b" ".join(words[int(i)] for i in rng.integers(0, 64, 1200)),
        b" ".join(words[int(i)] for i in rng.integers(0, 64, 5000)),
        bytes(rng.integers(0, 256, 9000, dtype=np.uint8)),
    ]
    enc = TpuEncoder(mesh=mesh)
    assert enc.frontend == "device"
    got = enc.encode_many(sources)
    for s, g in zip(sources, got):
        assert g == spec_encode(s)
