"""The GPU tANS kernels (ops/tans_gpu.py) on the CPU, and the choice of path.

The kernels run through the Pallas interpreter here; the `gpu`-marked tests
run them compiled and skip unless JAX's backend is a GPU (chip_smoke.py
runs the same comparison at the serving batch). The codec is integer-only:
every comparison with the plain XLA scans (ops/fse_decode.py,
ops/fse_encode.py) or the spec layer is exact, with no tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lzfse_rust_tpu.base import constants as C
from lzfse_rust_tpu.ops import tans_gpu as T
from lzfse_rust_tpu.utils import kernel_check as K

CORPUS_SETS = {
    "text": ["Mark.Twain-Tom.Sawyer.txt", "alice29.txt"],
    "incompressible": ["fireworks.jpeg", "paper-100k.pdf"],
    "structured": ["html", "geo.protodata", "kppkn.gtb"],
}


def _containers(snappy_dir, names):
    return [(snappy_dir / f"{n}.lzfse").read_bytes() for n in names]


def _raws(snappy_dir, names):
    from lzfse_rust_tpu.runtime import native
    return [native.decode_bytes(c) for c in _containers(snappy_dir, names)]


@pytest.mark.parametrize("family", sorted(CORPUS_SETS))
def test_decode_kernels_match_xla_scans(snappy_dir, family):
    case = K.decode_case(_containers(snappy_dir, CORPUS_SETS[family]))
    assert case["nb"] >= 2
    kern = K.run_decode_kernels(case, interpret=True)
    assert K.compare_decode(case, kern, K.run_decode_reference(case)) == 0


@pytest.mark.parametrize("family", sorted(CORPUS_SETS))
def test_emission_kernels_match_xla_scans(snappy_dir, family):
    case = K.encode_case(_raws(snappy_dir, CORPUS_SETS[family]))
    assert case["nb"] >= 2
    kern = K.run_encode_kernels(case, interpret=True)
    assert K.compare_encode(case, kern, K.run_encode_reference(case)) == 0


def test_single_parts_match_runs(snappy_dir):
    """decode_parts / encode_parts (each kernel and scan alone, as timed on
    the card) compute what run_* compute together."""
    names = CORPUS_SETS["structured"]
    case = K.decode_case(_containers(snappy_dir, names))
    parts = dict(K.decode_parts(case, interpret=True))
    lit, lfin = parts["literal decode kernel"]()
    lm, dd, mfin = parts["L/M/D decode kernel"]()
    kern = K.run_decode_kernels(case, interpret=True)
    for a, b in zip((lit, lm, dd, lfin, mfin), kern):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    ref = (parts["literal decode XLA scan"]()
           + parts["L/M/D decode XLA scan"]())
    assert K.compare_decode(case, kern, ref) == 0
    ecase = K.encode_case(_raws(snappy_dir, names))
    parts = dict(K.encode_parts(ecase, interpret=True))
    kern = (parts["literal emission kernel"]()
            + parts["L/M/D emission kernel"]())
    ref = (parts["literal emission XLA scan"]()
           + parts["L/M/D emission XLA scan"]())
    assert K.compare_encode(ecase, kern, ref) == 0


def test_device_seconds_needs_gpu_events():
    """The profiler reading runs the trace, and on a backend without GPU
    streams raises instead of reporting host time; it leaves no trace."""
    from lzfse_rust_tpu.utils.jax_cache import CHECKOUT
    x = jnp.arange(64)
    with pytest.raises(RuntimeError, match="no GPU stream events"):
        K.device_seconds(lambda: x * 2, runs=1)
    assert not (CHECKOUT / ".jax_trace").exists()


def test_decode_kernels_match_spec_block(mutate_dir):
    """Literals and L/M/D rows of one block equal the spec decoder's."""
    import lzfse_rust_tpu.models.decoder as M
    from lzfse_rust_tpu.spec import fse as SF
    from lzfse_rust_tpu.spec import tables as ST

    src = (mutate_dir / "vx2.lzfse").read_bytes()
    fse: list = []
    M._parse_container(src, 0, fse)
    d = fse[0]
    case = K.decode_case([src])
    lit, lm, dd, lfin, mfin = (np.asarray(x) for x in
                               K.run_decode_kernels(case, interpret=True))
    tabs = ST.DecoderTables(d.weights)
    want_l = np.asarray(SF.decode_literals(d.lit_payload, tabs,
                                           d.block.literal), np.uint8)
    want_r = np.asarray(SF.decode_lmds(d.lmd_payload, tabs, d.block.lmd))
    n_l, n_m = d.block.literal.num, d.block.lmd.num
    assert np.array_equal(lit.view(np.uint8)[:n_l], want_l[:n_l])
    assert np.array_equal(lm[:n_m] & 0xFFFF, want_r[:n_m, 0])
    assert np.array_equal(lm[:n_m] >> 16, want_r[:n_m, 1])
    assert np.array_equal(dd[:n_m], want_r[:n_m, 2])
    assert (lfin[0, :4] == 0).all() and lfin[0, 4] >= 64
    assert tuple(mfin[0, :3]) == (0, C.L_STATES, C.L_STATES + C.M_STATES)


def _random_decode_inputs(rng, B, n_words=512):
    """Garbage streams over random normalized tables: exercises latch
    states, reads below bit 0 and every lane position of a warp."""
    from lzfse_rust_tpu.ops.table_build import build_decode_tables
    w = np.zeros((B, C.N_WEIGHTS), np.int32)
    for lo, hi, tot in ((0, C.L_TOP, C.L_STATES), (C.L_TOP, C.M_TOP,
                        C.M_STATES), (C.M_TOP, C.D_TOP, C.D_STATES),
                        (C.D_TOP, C.U_TOP, C.U_STATES)):
        for b in range(B):
            # some classes under-filled: states past the total latch
            n = tot - int(rng.integers(0, 3)) * (tot // 8)
            cut = np.sort(rng.choice(np.arange(1, n), hi - lo - 1))
            w[b, lo:hi] = np.diff(np.concatenate(([0], cut, [n])))
    vp, vb, up = build_decode_tables(jnp.asarray(w))
    words = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(
        np.uint32)
    base = rng.integers(0, n_words // 2, B).astype(np.int32)
    pos = rng.integers(-5, 64 * 32, B).astype(np.int32)
    num = rng.integers(0, 160, B).astype(np.int32)
    lit_states = rng.integers(0, C.U_STATES, (B, 4)).astype(np.int32)
    lmd_states = np.stack([rng.integers(0, 64, B), 64 + rng.integers(0, 64, B),
                           128 + rng.integers(0, 256, B)], 1).astype(np.int32)
    return vp, vb, up, words, base, pos, num, lit_states, lmd_states


@pytest.mark.parametrize("B", [1, 31, 33, 70])
def test_decode_kernels_random_streams_exact(B):
    """Odd batch sizes (one partial warp, several warps), zero-count
    blocks, dense output offsets, and invalid streams: the kernels equal
    the XLA scans bit for bit, including final states and positions."""
    from lzfse_rust_tpu.ops.fse_decode import (decode_literals_batch,
                                               decode_lmds_batch)
    rng = np.random.default_rng(B)
    vp, vb, up, words, base, pos, num, ls, ms = _random_decode_inputs(rng, B)
    steps = (num + 3) // 4
    off_l = np.concatenate(([0], np.cumsum(steps)[:-1])).astype(np.int32)
    off_m = np.concatenate(([0], np.cumsum(num)[:-1])).astype(np.int32)
    n_out = int(num.sum()) + 7
    lit, lfin = T.decode_literals(up, jnp.asarray(words), base, pos, ls, num,
                                  off_l, n_out=n_out, interpret=True)
    lm, dd, mfin = T.decode_lmds(vp, jnp.asarray(words), base, pos, ms, num,
                                 off_m, n_out=n_out, interpret=True)
    # reference windows: each block's words from its base, as bytes
    wb = words.view(np.uint8)
    pay = np.zeros((B, 2048 + 8), np.uint8)
    for b in range(B):
        seg = wb[base[b] * 4:]
        pay[b, :len(seg)] = seg[:2048 + 8]
    from lzfse_rust_tpu.ops.fse_decode import bytes_to_windows
    win = bytes_to_windows(jnp.asarray(pay))
    r_lit, r_lfs, r_lfp = decode_literals_batch(
        up, win, jnp.asarray(ls), jnp.asarray(pos), jnp.asarray(num), 40)
    r_lmd, r_mfs, r_mfp = decode_lmds_batch(
        vp, vb, win, jnp.asarray(ms), jnp.asarray(pos), jnp.asarray(num),
        160)
    lit8 = np.asarray(lit).view(np.uint8)
    lm, dd = np.asarray(lm), np.asarray(dd)
    r_lit, r_lmd = np.asarray(r_lit), np.asarray(r_lmd)
    for b in range(B):
        n, o = int(num[b]), int(off_l[b]) * 4
        assert np.array_equal(lit8[o:o + 4 * steps[b]],
                              r_lit[b, :4 * steps[b]]), b
        o = int(off_m[b])
        assert np.array_equal(lm[o:o + n],
                              r_lmd[b, :n, 0] | (r_lmd[b, :n, 1] << 16)), b
        assert np.array_equal(dd[o:o + n], r_lmd[b, :n, 2]), b
    assert np.array_equal(np.asarray(lfin)[:, :4], np.asarray(r_lfs))
    assert np.array_equal(np.asarray(lfin)[:, 4], np.asarray(r_lfp))
    assert np.array_equal(np.asarray(mfin)[:, :3], np.asarray(r_mfs))
    assert np.array_equal(np.asarray(mfin)[:, 3], np.asarray(r_mfp))


def test_lane_params_sort_and_pad():
    """Blocks are sorted longest chain first, padded to whole warps with
    zero-step lanes whose ids run past the last block."""
    steps = jnp.asarray([3, 9, 0, 9, 1], jnp.int32)
    par, Bp = T._lane_params(steps, [steps, steps * 10])
    par = np.asarray(par)
    assert Bp == T.LANES and par.shape == (T.LANES, 3)
    assert par[:5, 0].tolist() == [1, 3, 0, 4, 2]
    assert par[:5, 1].tolist() == [9, 9, 3, 1, 0]
    assert par[5:, 0].tolist() == list(range(5, T.LANES))
    assert (par[5:, 1:] == 0).all()


def test_d_base_closed_form():
    """The L/M/D decode kernel's D-base arithmetic equals D_BASE_VALUE."""
    j = np.arange(C.D_SYMBOLS)
    assert np.array_equal(((4 + (j & 3)) << (j >> 2)) - 4, C.D_BASE_VALUE)


def test_lm_symbol_thresholds():
    """The emission kernel's L/M symbol counting equals the value->symbol
    tables."""
    for vmax, base_of, t in ((C.MAX_L_VALUE, C.L_BASE_FROM_VALUE,
                              (20, 28, 60)),
                             (C.MAX_M_VALUE, C.M_BASE_FROM_VALUE,
                              (24, 56, 312))):
        v = np.arange(vmax + 1)
        sym = np.where(v < 16, v, 16 + (v >= t[0]) + (v >= t[1])
                       + (v >= t[2]))
        assert np.array_equal(sym, base_of[:vmax + 1])


def test_select_path():
    assert T.select_path("cpu") == "cpu"
    assert T.select_path("gpu") == "gpu"
    assert T.select_path() == jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError):
        T.select_path("rocm")


def test_unknown_backend_raises(monkeypatch):
    from lzfse_rust_tpu.models.decoder import TpuDecoder
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError):
        TpuDecoder()
    with pytest.raises(RuntimeError):
        TpuEncoder()


def test_cpu_path_defaults(mutate_dir):
    from lzfse_rust_tpu.models.decoder import TpuDecoder
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    dec = TpuDecoder()
    assert dec.path == "cpu"
    src = (mutate_dir / "vx2.lzfse").read_bytes()
    dec.decode_many([src])
    assert dec.last_path == "cpu"
    enc = TpuEncoder()
    assert not enc.device_emission and enc.frontend == "device"
    with pytest.raises(ValueError):
        from lzfse_rust_tpu.parallel.mesh import make_mesh
        TpuDecoder(mesh=make_mesh(jax.devices()[:2]))


def test_gpu_path_decode_many(snappy_dir, gpu_path):
    """decode_many on the GPU path (kernels interpreted): SHA-equal, no
    fallback, path reported."""
    import hashlib

    from lzfse_rust_tpu.models.decoder import TpuDecoder
    paths = sorted(snappy_dir.glob("*.lzfse"))[:6]
    assert len(paths) == 6
    dec = TpuDecoder()
    stats: dict = {}
    outs = dec.decode_many([p.read_bytes() for p in paths] * 2, stats=stats)
    assert stats.get("fallbacks", 0) == 0
    assert dec.last_path == "gpu" and dec.last_devices == [0]
    for p, out in zip(paths * 2, outs):
        assert hashlib.sha256(out).digest() == \
            p.with_suffix(".hash").read_bytes()


def test_gpu_path_encode_identity(snappy_dir, gpu_path):
    """encode_many and encode_bytes on the GPU path (emission kernels
    interpreted) equal the native encoder, with a period-split source."""
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    from lzfse_rust_tpu.runtime import native
    raws = _raws(snappy_dir, ["Mark.Twain-Tom.Sawyer.txt", "html",
                              "fireworks.jpeg"])
    rng = np.random.default_rng(13)
    pat = rng.integers(0, 256, 13, dtype=np.uint8).tobytes()
    raws.append((pat * 4000)[:50000])
    enc = TpuEncoder()
    assert enc.device_emission and enc.frontend == "native"
    assert enc.encode_many(raws) == [native.encode_bytes(r) for r in raws]
    assert enc.last_emission == "device"
    assert enc.encode_bytes(raws[1]) == native.encode_bytes(raws[1])
    dev = TpuEncoder(frontend="device")
    assert dev.encode_many(raws[1:2]) == [native.encode_bytes(raws[1])]
    assert dev.last_emission == "device"


@pytest.mark.parametrize("entry", ["encode_many", "encode_bytes",
                                   "device_frontend"])
def test_device_emission_failure_raises(gpu_path, monkeypatch, entry):
    """A failure on the device-emission path propagates: no host encoder
    result is swapped in."""
    import lzfse_rust_tpu.models.encoder as E

    def broken(*a, **k):
        raise RuntimeError("emission kernel failed")

    monkeypatch.setattr(E, "_emission_kernels", broken)
    src = b"emission failure must surface " * 400
    enc = E.TpuEncoder(frontend="device" if entry == "device_frontend"
                       else None)
    with pytest.raises(RuntimeError, match="emission kernel failed"):
        if entry == "encode_bytes":
            enc.encode_bytes(src)
        else:
            enc.encode_many([src])


@pytest.mark.gpu
def test_kernels_compiled_match_xla_scans(snappy_dir):
    """On a GPU: the compiled kernels against the XLA scans."""
    names = sum(CORPUS_SETS.values(), [])
    case = K.decode_case(_containers(snappy_dir, names))
    assert K.compare_decode(case, K.run_decode_kernels(case),
                            K.run_decode_reference(case)) == 0
    ecase = K.encode_case(_raws(snappy_dir, names))
    assert K.compare_encode(ecase, K.run_encode_kernels(ecase),
                            K.run_encode_reference(ecase)) == 0
