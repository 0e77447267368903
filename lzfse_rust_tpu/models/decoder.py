"""TpuDecoder — the batched decode pipeline ("flagship model", decode side).

Architecture (a batch-parallel redesign of the reference's sequential
block-dispatch loop, src/decode/decoder.rs:72-99):

  host:   container walk -> FSE block descriptors, weight tables, packed
          payloads (native runtime); LZVN/Raw blocks stay in the sources
  device: literal + LMD tANS decode of every FSE block in the call at once
  host:   per-container flatten + LZ reconstruction (native, threaded)

The decode path is chosen by backend (ops/tans_gpu.select_path). On the GPU
every FSE block gets one thread of the tANS kernels (ops/tans_gpu.py) and
the native runtime does the host stages; a mesh shards the blocks over its
devices. On the CPU the same semantics run as the portable Python parse +
XLA scans (ops/fse_decode.py) + native or XLA LZ rebuild (ops/lz_rebuild.py)
— the plain reference the kernels are checked against.

Validity is checked with the same conditions the reference enforces
(final states == defaults, payload underflow, literal/raw-count bounds,
distance bounds); containers that fail any check are re-decoded through the
scalar spec layer so error semantics match exactly, and counted in
stats["fallbacks"].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..base import constants as C
from ..base.errors import BadBlock, DecodeError, PayloadOverflow, PayloadUnderflow
from ..spec import container as spec_container
from ..spec import fse as F
from ..spec import vn as V
from ..spec import weights as W

# Payload pads: fixed static shapes keep one XLA compilation alive across
# calls. Literal payload max = 50000B stream + 8 pad; LMD max = 67508.
LIT_PAYLOAD_PAD = 50016
LMD_PAYLOAD_PAD = 67520
_PAD_TAIL = 8  # window slack

@dataclass
class _FseBlockDesc:
    container: int
    order: int  # position among the container's blocks
    block: F.FseBlock
    weights: np.ndarray
    lit_payload: bytes  # includes leading 8 borrowed/pad bytes
    lmd_payload: bytes  # includes its own leading 8 pad bytes


@dataclass
class _ParsedContainer:
    # per-block entries in stream order: ("fse", fse_index) | rows/literals
    parts: list = field(default_factory=list)
    n_raw: int = 0


def _native_mod():
    """The native runtime module, or None when it cannot be built."""
    from ..runtime import native
    return native if native.available() else None


def _weights_v2(payload: bytes) -> np.ndarray:
    """V2 weight Huffman decode — native engine when built (the Python
    nibble loop costs ~0.3ms/block and dominated host parse)."""
    n = _native_mod()
    if n is not None:
        return n.load_weights_v2(payload)
    return W.load_v2(payload)


def _parse_container(src: bytes, ci: int, fse_blocks: list) -> _ParsedContainer:
    """Walk one container, collecting FSE payloads and host-parsed rows."""
    out = _ParsedContainer()
    pos = 0
    n = len(src)
    while True:
        if n - pos < 4:
            raise PayloadUnderflow("container truncated")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic == C.MAGIC_EOS:
            pos += 4
            break
        if magic in (C.MAGIC_VX2, C.MAGIC_VX1):
            if magic == C.MAGIC_VX2:
                block, nw = F.load_v2_header(
                    spec_container._take(src, pos, C.V2_HEADER_SIZE))
                weights = _weights_v2(
                    spec_container._take(src, pos + C.V2_HEADER_SIZE, nw))
                payload_start = pos + C.V2_HEADER_SIZE + nw
            else:
                block = F.load_v1_header(
                    spec_container._take(src, pos, C.V1_HEADER_SIZE))
                weights = W.load_v1(spec_container._take(
                    src, pos + C.V1_HEADER_SIZE, C.V1_WEIGHT_PAYLOAD_BYTES))
                payload_start = pos + C.V1_HEADER_SIZE + C.V1_WEIGHT_PAYLOAD_BYTES
            lit_payload = spec_container._take(
                src, payload_start - 8, block.literal.n_payload_bytes + 8)
            lmd_start = payload_start + block.literal.n_payload_bytes
            lmd_payload = spec_container._take(
                src, lmd_start, block.lmd.n_payload_bytes)
            # BitReader init padding checks (bit_reader.rs:25-27).
            for payload, bits in ((lit_payload, block.literal.bits),
                                  (lmd_payload, block.lmd.bits)):
                if bits and int.from_bytes(payload[-8:], "little") >> (64 - bits):
                    raise DecodeError("BadBitStream")
            out.parts.append(("fse", len(fse_blocks)))
            fse_blocks.append(_FseBlockDesc(
                ci, len(out.parts) - 1, block, weights, lit_payload,
                lmd_payload))
            out.n_raw += block.n_raw_bytes
            pos = lmd_start + block.lmd.n_payload_bytes
        elif magic == C.MAGIC_VXN:
            header = spec_container._take(src, pos, C.VN_HEADER_SIZE)
            n_raw_b = int.from_bytes(header[4:8], "little")
            n_pay = int.from_bytes(header[8:12], "little")
            payload = spec_container._take(src, pos + C.VN_HEADER_SIZE, n_pay)
            rows, lits = V.parse_vn_rows(payload, n_raw_b, n_pay)
            out.parts.append(("rows", rows, lits))
            out.n_raw += n_raw_b
            pos += C.VN_HEADER_SIZE + n_pay
        elif magic == C.MAGIC_RAW:
            header = spec_container._take(src, pos, C.RAW_HEADER_SIZE)
            n_raw_b = int.from_bytes(header[4:8], "little")
            data = spec_container._take(src, pos + C.RAW_HEADER_SIZE, n_raw_b)
            rows = np.array([[n_raw_b, 0, 0]], dtype=np.int32)
            out.parts.append(("rows", rows, data))
            out.n_raw += n_raw_b
            pos += C.RAW_HEADER_SIZE + n_raw_b
        else:
            raise BadBlock(magic)
    if n - pos != 0:
        raise PayloadOverflow("trailing bytes after EOS")
    return out


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _bucket(x: int, lo: int = 1) -> int:
    """Round up to a power of two (>= lo) so jit shapes stay cacheable."""
    x = max(x, lo)
    return 1 << (x - 1).bit_length()




import functools


@functools.lru_cache(maxsize=1)
def _substitute_fn():
    import jax
    from ..ops.lz_rebuild import substitute_distances

    @jax.jit
    def go(x):
        return x.at[:, :, 2].set(substitute_distances(x[:, :, 2]))
    return go


def _substitute_jit(lmds):
    """Apply per-block distance zero-substitution on device (jitted)."""
    return _substitute_fn()(lmds)


_PREP_CACHE: dict = {}
# Payload alignment in the packed upload: tl_gather_payloads zero-fills
# each payload up to it, which also leaves the kernels' one-word read-ahead
# inside the upload.
_ALIGN = 512
# Upload and output lengths round up to this many words, so a serving
# batch of similar size reuses one compiled kernel.
_WORDS_GRAIN = 1 << 16

# Uninitialized-bytes allocation + buffer address (CPython C API via
# ctypes): lets the native rebuild fill final `bytes` results in place.
import ctypes as _ct  # noqa: E402

_PyBytes_New = _ct.pythonapi.PyBytes_FromStringAndSize
_PyBytes_New.restype = _ct.py_object
_PyBytes_New.argtypes = [_ct.c_char_p, _ct.c_ssize_t]
_PyBytes_AsString = _ct.pythonapi.PyBytes_AsString
_PyBytes_AsString.restype = _ct.c_void_p
_PyBytes_AsString.argtypes = [_ct.py_object]


def _new_bytes(n: int) -> bytes:
    """A fresh UNINITIALIZED bytes object of length n (contents garbage
    until the native rebuild fills it)."""
    return _PyBytes_New(None, n)


def _bytes_addr(b: bytes) -> int:
    return _PyBytes_AsString(b) or 0


def _words_bucket(n: int) -> int:
    return _round_up(max(n, 1), _WORDS_GRAIN)


# Per-block parameter columns of the kernel input `small` (int32): literal
# stream base word / bit position / count / output offset / 4 states, then
# the same for the L/M/D stream (3 states, compound-table offsets applied).
_SMALL_COLS = 16


def _payload_layout(d) -> np.ndarray:
    """Byte offsets in the packed upload of each block's literal payloads,
    then its L/M/D payloads (desc rows d), each at an _ALIGN boundary; the
    last entry is the end."""
    lens = np.concatenate([d[:, 6], d[:, 8]]).astype(np.int64)
    return np.concatenate(([0], np.cumsum(_round_up_arr(lens, _ALIGN))))


def _prep_shard(native_mod, sources, d, w16, dst, n_rows: int, words):
    """Host inputs of one device's share of the FSE blocks (desc rows d,
    payload layout dst from _payload_layout): the packed payloads written
    into `words` (uint32, zero past the last payload), decode tables and
    per-block parameters padded to n_rows blocks, and the dense output
    offsets (literal words, L/M/D rows)."""
    nb = len(d)
    native_mod.gather_payloads(sources, np.ascontiguousarray(d), dst[:nb],
                               dst[nb:2 * nb], words.view(np.uint8))
    words[int(dst[-1]) // 4:] = 0
    v_tab = np.zeros((n_rows, 384), np.int32)
    u_tab = np.zeros((n_rows, 1024), np.int32)
    rows = np.arange(nb, dtype=np.int32)
    native_mod.build_tables_batch(np.ascontiguousarray(w16), rows, rows,
                                  v_tab, u_tab)
    lit_words = (d[:, 1].astype(np.int64) + 3) // 4
    off_l = np.concatenate(([0], np.cumsum(lit_words)))
    off_m = np.concatenate(([0], np.cumsum(d[:, 2].astype(np.int64))))
    small = np.zeros((n_rows, _SMALL_COLS), np.int32)
    small[:nb, 0] = dst[:nb] // 4
    small[:nb, 1] = d[:, 6].astype(np.int64) * 8 - d[:, 3]
    small[:nb, 2] = d[:, 1]
    small[:nb, 3] = off_l[:-1]
    small[:nb, 4:8] = d[:, 9:13]
    small[:nb, 8] = dst[nb:2 * nb] // 4
    small[:nb, 9] = d[:, 8].astype(np.int64) * 8 - d[:, 4]
    small[:nb, 10] = d[:, 2]
    small[:nb, 11] = off_m[:-1]
    small[:nb, 12:15] = d[:, 13:16] + np.array(
        [0, C.L_STATES, C.L_STATES + C.M_STATES], np.int32)
    return v_tab, u_tab, small, off_l, off_m


def _round_up_arr(x: np.ndarray, m: int) -> np.ndarray:
    return (x + m - 1) // m * m


def entropy_decode(u_tab, v_tab, words, small, *, n_lit: int, n_lmd: int,
                   interpret: bool = False):
    """One device's tANS decode: both GPU kernels over its blocks. Returns
    (literal words (n_lit,), lm (n_lmd,), d (n_lmd,), literal finals
    (B, 5), L/M/D finals (B, 4)) — see ops/tans_gpu."""
    from ..ops import tans_gpu as T
    lit, lfin = T.decode_literals(
        u_tab, words, small[:, 0], small[:, 1], small[:, 4:8], small[:, 2],
        small[:, 3], n_out=n_lit, interpret=interpret)
    lm, d, mfin = T.decode_lmds(
        v_tab, words, small[:, 8], small[:, 9], small[:, 12:15],
        small[:, 10], small[:, 11], n_out=n_lmd, interpret=interpret)
    return lit, lm, d, lfin, mfin


class TpuDecoder:
    """Batched container decoder running the compute path on the JAX device.

    The path follows the backend (ops/tans_gpu.select_path): "gpu" runs the
    tANS kernels with the native runtime around them (required there: a
    failed build raises); "cpu" runs the XLA scans. `last_path` names the
    path the last decode_many ran its FSE blocks on ("gpu", "cpu", or None
    when the call had no FSE block); on the GPU path `last_devices` lists
    the ids of the devices that held the kernel outputs.
    """

    def __init__(self, use_native_rebuild: bool | None = None, mesh=None):
        """mesh: optional 1-D jax.sharding.Mesh (parallel/mesh.make_mesh).
        Every decode_many call then splits its FSE blocks across the mesh
        devices and runs the tANS kernels on each under shard_map (GPU path
        only). use_native_rebuild: CPU path only — False runs the XLA LZ
        rebuild instead of the native one."""
        import jax.numpy as jnp  # deferred so pure-spec users never pay
        from ..ops import tans_gpu
        self._jnp = jnp
        self.mesh = mesh
        self.path = tans_gpu.select_path()
        self.last_path = None
        self.last_devices: list[int] = []
        if self.path == "gpu":
            from ..runtime import native
            native.require()
            use_native_rebuild = True
        elif mesh is not None:
            raise ValueError("mesh-sharded decode runs the GPU kernels")
        if use_native_rebuild is None:
            use_native_rebuild = _native_mod() is not None
        self.use_native_rebuild = use_native_rebuild
        if use_native_rebuild and _native_mod() is not None:
            _native_mod().alloc_reuse()  # warm-page reuse for output bytes

    def _decode_many_walk(self, sources: list[bytes], stats: dict | None,
                          native_mod) -> list[bytes]:
        """GPU path: native batch container walk (parse), native payload
        gather + table build (prep), the tANS kernels (device), fused
        native flatten/rebuild with VN/RAW parts decoded straight from the
        sources. Containers the walk rejects are re-parsed in Python
        (raising the precise exception) or decoded via the spec layer."""
        results, fr = self._walk_front(sources, stats, native_mod)
        return self._walk_back(sources, results, fr, stats, native_mod)

    def _walk_front(self, sources: list[bytes], stats: dict | None,
                    native_mod):
        """Host front half of the GPU path: container walk, payload packing,
        table build, upload and kernel dispatch (no download — the device
        arrays stay in flight until _walk_back reads them). Returns
        (results, frame); results holds spec-layer decodes for containers
        the walk rejected."""
        import time as _time

        import jax

        from ..ops import tans_gpu

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        results: list = [None] * len(sources)
        desc, w16, parts, cpo, cont_nraw, cont_ok = \
            native_mod.walk_batch(sources)
        for ci in np.flatnonzero(cont_ok == 0):
            ci = int(ci)
            # exact error semantics: the Python parse raises the precise
            # exception; if it parses clean (walk stricter only by i32
            # offsets), the spec layer decodes it correctly
            _parse_container(sources[ci], ci, [])
            if stats is not None:
                stats["fallbacks"] = stats.get("fallbacks", 0) + 1
            results[ci] = spec_container.decode_bytes(sources[ci])
        nb = len(desc)
        _mark("parse")
        if not nb:
            _mark("prep")
            return results, (None, parts, cpo, cont_nraw, cont_ok, nb)

        # contiguous block ranges, one per device
        n_dev = self.mesh.size if self.mesh is not None else 1
        splits = np.array_split(np.arange(nb), n_dev)
        n_rows = max(len(s) for s in splits)
        layouts = [_payload_layout(desc[idx]) for idx in splits]
        # _ALIGN spare bytes past the last payload: the kernels' read-ahead
        n_words = _words_bucket(max(int(dst[-1]) + _ALIGN
                                    for dst in layouts) // 4)
        words = np.empty((n_dev, n_words), np.uint32)
        shards = [_prep_shard(native_mod, sources, desc[idx], w16[idx], dst,
                              n_rows, words[k])
                  for k, (idx, dst) in enumerate(zip(splits, layouts))]
        # one spare output word: the kernels' scratch slot
        n_lit = _words_bucket(max(int(s[3][-1]) for s in shards) + 1)
        n_lmd = _words_bucket(max(int(s[4][-1]) for s in shards) + 1)
        host = (np.stack([s[1] for s in shards]),
                np.stack([s[0] for s in shards]), words,
                np.stack([s[2] for s in shards]))
        _mark("prep")
        interpret = tans_gpu.INTERPRET
        if self.mesh is not None:
            from ..parallel.mesh import sharded_tans_decode
            out = sharded_tans_decode(self.mesh, host, n_lit, n_lmd,
                                      interpret)
        else:
            dev = [jax.device_put(x[0]) for x in host]
            out = tuple(x[None] for x in entropy_decode(
                *dev, n_lit=n_lit, n_lmd=n_lmd, interpret=interpret))
        # global fse index -> (device, local block); dense output offsets
        shard_of = np.repeat(np.arange(n_dev), [len(s) for s in splits])
        local = np.concatenate([np.arange(len(s)) for s in splits])
        off_l = np.concatenate([s[3][:-1] for s in shards]) + shard_of * n_lit
        off_m = np.concatenate([s[4][:-1] for s in shards]) + shard_of * n_lmd
        _mark("dispatch")
        frame = ((out, shard_of, local, off_l, off_m), parts, cpo,
                 cont_nraw, cont_ok, nb)
        return results, frame

    def _walk_back(self, sources: list[bytes], results: list,
                   frame, stats: dict | None, native_mod) -> list[bytes]:
        """Back half of the GPU path: device download + stream validity,
        part flattening, and the threaded native LZ rebuild."""
        import time as _time

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        dev, parts, cpo, cont_nraw, cont_ok, nb = frame
        if dev is not None:
            out, shard_of, local, off_l, off_m = dev
            lit_d, lm_d, d_d, lfin_d, mfin_d = out
            lfin = np.asarray(lfin_d)[shard_of, local]
            mfin = np.asarray(mfin_d)[shard_of, local]
            # Stream validity (fse_core.rs:132-140 + literals.rs:79-87)
            fse_ok = ((lfin[:, :4] == 0).all(axis=1) & (lfin[:, 4] >= 64)
                      & (mfin[:, 0] == 0) & (mfin[:, 1] == C.L_STATES)
                      & (mfin[:, 2] == C.L_STATES + C.M_STATES)
                      & (mfin[:, 3] >= 64))
            # flat downloads: the native rebuild reads parts at absolute
            # word/byte offsets (stride 1)
            lit_arr = np.asarray(lit_d).reshape(-1).view(np.uint8)
            lm_arr = np.asarray(lm_d).reshape(-1)
            d_arr = np.asarray(d_d).reshape(-1)
            self.last_path = "gpu"
            self.last_devices = sorted(dv.id for dv in lit_d.devices())
        else:
            fse_ok = np.zeros(0, bool)
            lit_arr = np.zeros(4, np.uint8)
            lm_arr = np.zeros(1, np.int32)
            d_arr = np.zeros(1, np.int32)
            off_l = off_m = np.zeros(0, np.int64)
            self.last_path = None
        _mark("device")

        # per-container part slices; containers whose FSE streams failed
        # validity fall back to the exact spec layer
        keep_parts: list[np.ndarray] = []
        cont_ids: list[int] = []
        out_offs = [0]
        for ci in np.flatnonzero(cont_ok):
            ci = int(ci)
            sub = parts[cpo[ci]:cpo[ci + 1]]
            k0 = sub[sub[:, 0] == 0, 1]
            if len(k0) and not fse_ok[k0].all():
                if stats is not None:
                    stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                results[ci] = spec_container.decode_bytes(sources[ci])
                continue
            keep_parts.append(sub)
            cont_ids.append(ci)
            out_offs.append(out_offs[-1] + int(cont_nraw[ci]))
        parts_np = (np.ascontiguousarray(np.concatenate(keep_parts))
                    if keep_parts else np.zeros((0, 6), np.int32))
        # point each FSE part at its block's dense outputs (P[1] = lm/d
        # word offset, P[4] = literal byte offset; parts_np is a fresh
        # copy, safe to rewrite)
        if len(parts_np):
            k0 = parts_np[:, 0] == 0
            if k0.any():
                g = parts_np[k0, 1]
                parts_np[k0, 1] = off_m[g]
                parts_np[k0, 4] = off_l[g] * 4
        cont_off_np = np.zeros(len(cont_ids) + 1, np.int32)
        if keep_parts:
            cont_off_np[1:] = np.cumsum([len(p) for p in keep_parts])
        out_offs_np = np.asarray(out_offs, np.int64)
        # rebuild writes STRAIGHT into each container's final bytes object
        # (fresh uninitialized PyBytes; filling a never-exposed refcount-1
        # bytes is the standard CPython idiom) — the per-container
        # copy-out pass this replaces cost ~4x the replay itself.
        out_bytes = [_new_bytes(out_offs[k + 1] - out_offs[k])
                     for k in range(len(cont_ids))]
        out_ptrs = np.fromiter(
            (_bytes_addr(b) for b in out_bytes), np.int64,
            len(out_bytes)) if out_bytes else np.zeros(0, np.int64)
        empty_rows = np.zeros((1, 3), np.int32)
        empty_lits = np.zeros(1, np.uint8)
        dummy_out = np.zeros(1, np.uint8)
        _mark("flatten")
        status = native_mod.flatten_rebuild(
            lm_arr, d_arr, lit_arr, parts_np, cont_off_np, out_offs_np,
            empty_rows, empty_lits, dummy_out, sources=sources,
            out_ptrs=out_ptrs)
        for k, ci in enumerate(cont_ids):
            if status[k] == int(cont_nraw[ci]):
                results[ci] = out_bytes[k]
            else:
                if stats is not None:
                    stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                results[ci] = spec_container.decode_bytes(sources[ci])
        _mark("rebuild")
        return results

    def decode_many(self, sources: list[bytes],
                    stats: dict | None = None) -> list[bytes]:
        """Decode a batch of containers, block-parallel across all of them.

        `stats`, when given, receives wall-clock seconds per pipeline stage
        (GPU path: parse / prep / dispatch / device / flatten / rebuild;
        `device` is the wait for the kernels and the download) and the
        count of spec-layer re-decodes under "fallbacks".
        """
        import time as _time
        import jax.numpy as jnp
        from ..ops.fse_decode import (bytes_to_windows, decode_literals_batch,
                                      decode_lmds_batch)
        from ..ops.lz_rebuild import lz_rebuild_batch
        from ..ops.table_build import build_decode_tables

        if self.path == "gpu":
            from ..runtime import native
            return self._decode_many_walk(sources, stats, native)

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        fse_blocks: list[_FseBlockDesc] = []
        parsed = [_parse_container(s, i, fse_blocks)
                  for i, s in enumerate(sources)]
        _mark("parse")

        lit_arr = np.zeros((max(len(fse_blocks), 1), 0), dtype=np.uint8)
        self.last_path = "cpu" if fse_blocks else None
        if fse_blocks:
            B = _bucket(len(fse_blocks), 1)
            weights = np.zeros((B, C.N_WEIGHTS), dtype=np.int32)
            weights[:len(fse_blocks)] = np.stack(
                [d.weights for d in fse_blocks])
            litp = np.zeros((B, LIT_PAYLOAD_PAD + _PAD_TAIL), dtype=np.uint8)
            lmdp = np.zeros((B, LMD_PAYLOAD_PAD + _PAD_TAIL), dtype=np.uint8)
            lit_pos = np.full(B, 64, dtype=np.int32)
            lmd_pos = np.full(B, 64, dtype=np.int32)
            lit_states = np.zeros((B, 4), dtype=np.int32)
            lmd_states = np.zeros((B, 3), dtype=np.int32)
            lit_num = np.zeros(B, dtype=np.int32)
            lmd_num = np.zeros(B, dtype=np.int32)
            for i, d in enumerate(fse_blocks):
                lp, mp = d.lit_payload, d.lmd_payload
                litp[i, :len(lp)] = np.frombuffer(lp, dtype=np.uint8)
                lmdp[i, :len(mp)] = np.frombuffer(mp, dtype=np.uint8)
                lit_pos[i] = len(lp) * 8 - d.block.literal.bits
                lmd_pos[i] = len(mp) * 8 - d.block.lmd.bits
                lit_states[i] = d.block.literal.state
                ls = d.block.lmd.state
                lmd_states[i] = (ls[0], ls[1] + C.L_STATES,
                                 ls[2] + C.L_STATES + C.M_STATES)
                lit_num[i] = d.block.literal.num
                lmd_num[i] = d.block.lmd.num

            v_packed, v_base, u_packed = build_decode_tables(
                jnp.asarray(weights))
            lit_w = bytes_to_windows(jnp.asarray(litp))
            lmd_w = bytes_to_windows(jnp.asarray(lmdp))
            literals, lit_fs, lit_fp = decode_literals_batch(
                u_packed, lit_w, jnp.asarray(lit_states),
                jnp.asarray(lit_pos), jnp.asarray(lit_num),
                C.LITERALS_PER_BLOCK // 4)
            lmds, lmd_fs, lmd_fp = decode_lmds_batch(
                v_packed, v_base, lmd_w, jnp.asarray(lmd_states),
                jnp.asarray(lmd_pos), jnp.asarray(lmd_num),
                C.LMDS_PER_BLOCK)
            lmds = _substitute_jit(lmds)
            _mark("prep")

            # Stream validity (fse_core.rs:132-140 + literals.rs:79-87):
            # final states at defaults, no payload underflow (>= 64 bits of
            # pad remain).
            lit_ok = (np.asarray(lit_fs) == 0).all(axis=1)
            lit_ok &= np.asarray(lit_fp) >= 64
            lmd_fs_np = np.asarray(lmd_fs)
            lmd_ok = ((lmd_fs_np[:, 0] == 0)
                      & (lmd_fs_np[:, 1] == C.L_STATES)
                      & (lmd_fs_np[:, 2] == C.L_STATES + C.M_STATES))
            lmd_ok &= np.asarray(lmd_fp) >= 64
            fse_ok = lit_ok & lmd_ok
            # the native walker reads row-major
            lit_arr = np.ascontiguousarray(np.asarray(literals))
            lmd_arr = np.ascontiguousarray(np.asarray(lmds))
            _mark("device")
        else:
            fse_ok = np.zeros(0, dtype=bool)
            lmd_arr = np.zeros((1, 0, 3), dtype=np.int32)

        results: list[bytes | None] = [None] * len(sources)
        native_mod = _native_mod() if self.use_native_rebuild else None
        if native_mod is not None:
            # Fused flatten + rebuild: one threaded native call walks every
            # container's parts, reading the device kernels' decoded rows
            # and literal pools in place (no per-container concatenate
            # copies; the reference counterpart is the sequential fused
            # decode+copy loop, fse_core.rs:80-141).
            part_rows: list[tuple] = []
            cont_off = [0]
            out_offs = [0]
            cont_ids: list[int] = []
            hr_list: list[np.ndarray] = []
            hl_list: list[np.ndarray] = []
            hr_off = hl_off = 0
            for ci, pc in enumerate(parsed):
                if not all(fse_ok[p[1]] for p in pc.parts if p[0] == "fse"):
                    # exact error semantics via the scalar spec layer
                    if stats is not None:
                        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                    results[ci] = spec_container.decode_bytes(sources[ci])
                    continue
                for part in pc.parts:
                    if part[0] == "fse":
                        d = fse_blocks[part[1]]
                        # P[1]/P[4]: lm-d / literal array rows (this path
                        # passes unsorted arrays, so both equal the global
                        # block index)
                        part_rows.append((0, part[1], d.block.lmd.num,
                                          d.block.literal.num, part[1], 0))
                    else:
                        rows, lits = part[1], part[2]
                        if isinstance(lits, (bytes, bytearray)):
                            lits = np.frombuffer(lits, dtype=np.uint8)
                        part_rows.append(
                            (1, hr_off, len(rows), hl_off, len(lits), 0))
                        hr_list.append(rows)
                        hl_list.append(lits)
                        hr_off += len(rows)
                        hl_off += len(lits)
                cont_ids.append(ci)
                cont_off.append(len(part_rows))
                out_offs.append(out_offs[-1] + pc.n_raw)
            parts_np = (np.asarray(part_rows, np.int32)
                        if part_rows else np.zeros((0, 6), np.int32))
            host_rows = (np.ascontiguousarray(
                np.concatenate(hr_list), dtype=np.int32)
                if hr_list else np.zeros((1, 3), np.int32))
            host_lits = (np.ascontiguousarray(
                np.concatenate(hl_list), dtype=np.uint8)
                if hl_list else np.zeros(1, np.uint8))
            out_offs_np = np.asarray(out_offs, np.int64)
            # cached (8MiB-bucketed) output staging: a fresh 20MB+ np.empty
            # per call re-faults its pages inside the threaded rebuild
            total_out = max(int(out_offs_np[-1]), 1)
            out_key = ("out", _round_up(total_out, 8 << 20))
            out_buf = _PREP_CACHE.get(out_key)
            if out_buf is None:
                out_buf = np.empty(out_key[1], np.uint8)
                _PREP_CACHE[out_key] = out_buf
            _mark("flatten")
            # this path carries substituted (l, m, d) triplets; pack for
            # the native rebuild's lm/d layout (d already substituted, so
            # the native repeat-zeros pass is a no-op on it)
            lm_arr = lmd_arr[:, :, 0] | (lmd_arr[:, :, 1] << 16)
            status = native_mod.flatten_rebuild(
                lm_arr, np.ascontiguousarray(lmd_arr[:, :, 2]), lit_arr,
                parts_np, np.asarray(cont_off, np.int32), out_offs_np,
                host_rows, host_lits, out_buf)
            for k, ci in enumerate(cont_ids):
                if status[k] == parsed[ci].n_raw:
                    results[ci] = out_buf[out_offs[k]:out_offs[k + 1]] \
                        .tobytes()
                else:
                    if stats is not None:
                        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                    results[ci] = spec_container.decode_bytes(sources[ci])
            _mark("rebuild")
            return results  # type: ignore[return-value]

        # Portable path: flatten each container's parts into one row stream
        # + literal pool, then the XLA pointer-doubling rebuild.
        conts: list[tuple[int, np.ndarray, np.ndarray]] = []
        for ci, pc in enumerate(parsed):
            rows_list, lit_list = [], []
            valid = True
            for part in pc.parts:
                if part[0] == "fse":
                    bi = part[1]
                    if not fse_ok[bi]:
                        valid = False
                        break
                    d = fse_blocks[bi]
                    nl = d.block.lmd.num
                    rows = lmd_arr[bi, :nl]
                    # literal-count consistency (fse_core.rs:133)
                    consumed = int(rows[:, 0].sum())
                    if consumed > d.block.literal.num:
                        valid = False
                        break
                    rows_list.append(rows)
                    # Only the literals the rows actually consume enter the
                    # pool: the stored literal count is padded to 4
                    # (literals.rs:135-145) and trailing pads are never
                    # referenced; keeping them would misalign the flattened
                    # cross-block literal indexing.
                    lit_list.append(lit_arr[bi, :consumed])
                else:
                    rows_list.append(part[1])
                    lit_list.append(np.frombuffer(part[2], dtype=np.uint8))
            if not valid:
                # exact error semantics via the scalar spec layer
                if stats is not None:
                    stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                results[ci] = spec_container.decode_bytes(sources[ci])
                continue
            rows = (np.concatenate(rows_list) if rows_list
                    else np.zeros((0, 3), dtype=np.int32))
            lits = (np.concatenate(lit_list) if lit_list
                    else np.zeros(0, dtype=np.uint8))
            conts.append((ci, rows, lits))

        _mark("flatten")

        if conts:
            Bc = _bucket(len(conts))
            r_max = _bucket(max(len(r) for _, r, _ in conts), 256)
            l_max = _bucket(max(max(len(li) for _, _, li in conts), 1), 4096)
            n_out = _bucket(max(parsed[ci].n_raw for ci, _, _ in conts) or 1,
                            4096)
            rows_b = np.zeros((Bc, r_max, 3), dtype=np.int32)
            lits_b = np.zeros((Bc, l_max), dtype=np.uint8)
            n_raw_b = np.zeros(Bc, dtype=np.int32)
            for k, (ci, rows, lits) in enumerate(conts):
                rows_b[k, :len(rows)] = rows
                lits_b[k, :len(lits)] = lits
                n_raw_b[k] = parsed[ci].n_raw
            out, ok = lz_rebuild_batch(jnp.asarray(lits_b),
                                       jnp.asarray(rows_b),
                                       jnp.asarray(n_raw_b), n_out)
            out_np = np.asarray(out)
            ok_np = np.asarray(ok)
            for k, (ci, _, _) in enumerate(conts):
                if ok_np[k]:
                    results[ci] = out_np[k, :parsed[ci].n_raw].tobytes()
                else:
                    if stats is not None:
                        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                    results[ci] = spec_container.decode_bytes(sources[ci])
            _mark("rebuild")
        return results  # type: ignore[return-value]

    def decode_bytes(self, src: bytes) -> bytes:
        return self.decode_many([src])[0]
