"""Native C++ runtime bindings (ctypes).

The C++ runtime implements the sequential host paths (scalar codec,
container assembly, streaming IO, the batch walk/rebuild around the device
kernels) at native speed — the role the reference's Rust core plays (it is
a 100%-native codec).

The shared library is built from src/tpulzfse.cpp at first use into
build/ (gitignored; the file name carries a hash of the source and flags,
so an edited source rebuilds). Builds are atomic and serialized by a file
lock, so concurrent processes (pytest-xdist workers) build once.
`available()` is False when the build fails; `require()` raises with the
compiler's message — the device paths use it, so a missing runtime is an
error there rather than a silent switch to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile

_SRC = pathlib.Path(__file__).parent / "src" / "tpulzfse.cpp"
_BUILD = pathlib.Path(__file__).parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall", "-pthread")

_LIB = None
_ERROR: str | None = None


class NativeBuildError(RuntimeError):
    """The native runtime could not be built or loaded."""


def available() -> bool:
    return _lib() is not None


def require():
    """The loaded library; raises NativeBuildError when it cannot be built."""
    lib = _lib()
    if lib is None:
        raise NativeBuildError(_ERROR or "native runtime unavailable")
    return lib


def library_path() -> pathlib.Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(
        CXX_FLAGS + (platform.machine(),)).encode()).hexdigest()[:16]
    return _BUILD / f"libtpulzfse-{key}.so"


def build() -> pathlib.Path:
    """Compile the runtime unless it exists; returns the library path."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    import fcntl
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while we waited
            return so
        fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so.tmp")
        os.close(fd)
        try:
            r = subprocess.run(
                ["g++", *CXX_FLAGS, "-o", tmp, str(_SRC)],
                capture_output=True, text=True)
            if r.returncode != 0:
                raise NativeBuildError(
                    f"g++ failed ({r.returncode}): {r.stderr[-2000:]}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def _lib():
    global _LIB, _ERROR
    if _LIB is None and _ERROR is None:
        try:
            lib = ctypes.CDLL(str(build()))
            _configure(lib)
            _LIB = lib
        except (OSError, NativeBuildError) as e:
            _ERROR = f"{type(e).__name__}: {e}"
    return _LIB


def _configure(lib) -> None:
    lib.tl_decode_bound.restype = ctypes.c_longlong
    lib.tl_decode_bound.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_decode.restype = ctypes.c_longlong
    lib.tl_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_decode_mt.restype = ctypes.c_longlong
    lib.tl_decode_mt.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_encode_mt.restype = ctypes.c_longlong
    lib.tl_encode_mt.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_encode_bound.restype = ctypes.c_longlong
    lib.tl_encode_bound.argtypes = [ctypes.c_size_t]
    lib.tl_encode.restype = ctypes.c_longlong
    lib.tl_encode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_select_emit_fse.restype = ctypes.c_longlong
    lib.tl_select_emit_fse.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_rebuild.restype = ctypes.c_longlong
    lib.tl_rebuild.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_stream_new.restype = ctypes.c_void_p
    lib.tl_stream_new.argtypes = []
    lib.tl_stream_free.restype = None
    lib.tl_stream_free.argtypes = [ctypes.c_void_p]
    lib.tl_stream_push.restype = ctypes.c_longlong
    lib.tl_stream_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.tl_stream_pull.restype = ctypes.c_longlong
    lib.tl_stream_pull.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.tl_stream_finish.restype = ctypes.c_longlong
    lib.tl_stream_finish.argtypes = [ctypes.c_void_p]
    lib.tl_scatter_rows.restype = ctypes.c_longlong
    lib.tl_scatter_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t]
    lib.tl_build_tables.restype = ctypes.c_longlong
    lib.tl_build_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.tl_flatten_rebuild.restype = ctypes.c_longlong
    lib.tl_flatten_rebuild.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.tl_alloc_reuse.restype = ctypes.c_longlong
    lib.tl_alloc_reuse.argtypes = []
    lib.tl_walk_batch.restype = ctypes.c_longlong
    lib.tl_walk_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tl_gather_payloads.restype = ctypes.c_longlong
    lib.tl_gather_payloads.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tl_build_tables_batch.restype = ctypes.c_longlong
    lib.tl_build_tables_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tl_load_weights_v2.restype = ctypes.c_longlong
    lib.tl_load_weights_v2.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_void_p]
    lib.tl_select_blocks.restype = ctypes.c_longlong
    lib.tl_select_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_frontend_blocks.restype = ctypes.c_longlong
    lib.tl_frontend_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_frontend_stage.restype = ctypes.c_longlong
    lib.tl_frontend_stage.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,   # src, n
        ctypes.c_void_p, ctypes.c_void_p,   # weights, litw
        ctypes.c_void_p, ctypes.c_void_p,   # lit_num, lmv
        ctypes.c_void_p, ctypes.c_void_p,   # dv, lmd_num
        ctypes.c_void_p, ctypes.c_void_p,   # meta, wpay
        ctypes.c_void_p,                    # wpay_len
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,                    # counter
        ctypes.c_void_p, ctypes.c_longlong]  # out_idx, out_cap
    lib.tl_pack_groups.restype = ctypes.c_longlong
    lib.tl_pack_groups.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_pack_stage.restype = ctypes.c_longlong
    lib.tl_pack_stage.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_longlong] * 5
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    lib.tl_block_weights.restype = ctypes.c_longlong
    lib.tl_block_weights.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.tl_match_group.restype = ctypes.c_longlong
    lib.tl_match_group.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.tl_enc_new.restype = ctypes.c_void_p
    lib.tl_enc_new.argtypes = []
    lib.tl_enc_free.restype = None
    lib.tl_enc_free.argtypes = [ctypes.c_void_p]
    lib.tl_enc_push.restype = ctypes.c_longlong
    lib.tl_enc_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.tl_enc_finish.restype = ctypes.c_longlong
    lib.tl_enc_finish.argtypes = [ctypes.c_void_p]
    lib.tl_enc_drain.restype = ctypes.c_longlong
    lib.tl_enc_drain.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t]


def decode_bytes(src: bytes, parallel: bool | None = None) -> bytes:
    """One-shot container decode. `parallel=None` auto-selects the
    multi-threaded engine (tl_decode_mt: per-block entropy decode on a
    worker pool + in-order LZ replay; byte-identical output, identical
    error codes — it falls back to the sequential engine on any error or
    when the container has too few FSE blocks to pay for threads)."""
    import ctypes
    import numpy as np
    from ..base.errors import DecodeError
    lib = _lib()
    bound = lib.tl_decode_bound(src, len(src))
    if bound < 0:
        raise DecodeError(f"probe failed: {bound}")
    # np.empty avoids the zero-fill of create_string_buffer — that memset
    # runs under the GIL and throttles thread-pooled batch decodes
    out = np.empty(max(int(bound), 1), dtype=np.uint8)
    fn = lib.tl_decode if parallel is False else lib.tl_decode_mt
    n = fn(src, len(src), out.ctypes.data_as(ctypes.c_char_p), int(bound))
    if n < 0:
        raise DecodeError(f"decode failed: {n}")
    return out[:n].tobytes()


def decode_bound(src: bytes) -> int:
    """Decoded-size bound from the container probe (tl_decode_bound)."""
    from ..base.errors import DecodeError
    lib = _lib()
    bound = lib.tl_decode_bound(src, len(src))
    if bound < 0:
        raise DecodeError(f"probe failed: {bound}")
    return int(bound)


def decode_into(src, out, parallel: bool | None = None) -> int:
    """Zero-copy one-shot decode into a caller-owned uint8 array; returns
    the decoded length. The serving analog of the reference's
    decode_bytes-into-Vec without the final Python bytes copy — under a
    thread pool the GIL-held work shrinks to the ctypes call itself, so
    container-parallel batch decode scales with cores (the bytes-returning
    wrapper's tobytes() copy serializes ~20%/container on this box)."""
    import ctypes
    from ..base.errors import DecodeError
    lib = _lib()
    fn = lib.tl_decode if parallel is False else lib.tl_decode_mt
    n = fn(src, len(src), out.ctypes.data_as(ctypes.c_char_p), out.size)
    if n < 0:
        raise DecodeError(f"decode failed: {n}")
    return int(n)


def encode_bytes(src: bytes, parallel: bool | None = None) -> bytes:
    """One-shot container encode. `parallel=None` auto-selects the
    emission-parallel engine (tl_encode_mt: exact sequential frontend +
    pooled per-block tANS emission; byte-identical output — small inputs
    route to the sequential engine inside)."""
    import ctypes
    import numpy as np
    from ..base.errors import LzfseError
    lib = _lib()
    bound = int(lib.tl_encode_bound(len(src)))
    out = np.empty(bound, dtype=np.uint8)
    fn = lib.tl_encode if parallel is False else lib.tl_encode_mt
    n = fn(src, len(src), out.ctypes.data_as(ctypes.c_char_p), bound)
    if n < 0:
        raise LzfseError(f"encode failed: {n}")
    return out[:n].tobytes()


def select_emit_fse(src: bytes, stream_rows) -> bytes:
    """Selection + FSE block emission from (pos, match_pos, fwd_len,
    back_max) int64 rows sorted by pos. Returns the window's block body."""
    import ctypes
    import numpy as np
    from ..base.errors import LzfseError
    lib = _lib()
    rows = np.ascontiguousarray(stream_rows, dtype=np.int64)
    cap = len(src) + len(src) // 2 + 8192
    out = ctypes.create_string_buffer(cap)
    n = lib.tl_select_emit_fse(
        src, len(src), rows.ctypes.data_as(ctypes.c_void_p), rows.shape[0],
        out, cap)
    if n < 0:
        raise LzfseError(f"select_emit failed: {n}")
    return out.raw[:n]


def scatter_rows(cat: bytes, offs, slots, dst) -> None:
    """Scatter concatenated payloads into rows of the 2D staging buffer
    `dst` at row indices `slots`, zeroing an 8-byte tail after each."""
    import numpy as np
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    _lib().tl_scatter_rows(cat, offs.ctypes.data, slots.ctypes.data,
                           len(slots), dst.ctypes.data, dst.strides[0])


def build_tables_into(weights, v_row, u_row) -> None:
    """Build one block's packed decode tables (format of ops/table_build)
    into caller arrays: v_row int32[384], u_row int32[1024]."""
    import numpy as np
    w16 = np.ascontiguousarray(weights, dtype=np.uint16)
    _lib().tl_build_tables(w16.ctypes.data, v_row.ctypes.data,
                           u_row.ctypes.data)


def _src_ptrs(sources):
    """(char** array, keepalive) for a list of bytes objects."""
    arr = (ctypes.c_char_p * len(sources))(*sources)
    return arr


def walk_batch(sources):
    """Native batch container walk (the TpuDecoder parse stage).

    Returns (desc (n_fse, 20) int32, weights (n_fse, 360) uint16,
    parts (n_parts, 6) int32, cont_part_off (n+1,) int32,
    cont_nraw (n,) int64, cont_ok (n,) int32). Containers with cont_ok=0
    contributed nothing; the caller re-parses them in Python for exact
    error semantics. Part kinds: 0 = FSE (a = fse idx), 2 = LZVN payload
    in src, 3 = RAW body in src (see tpulzfse.cpp tl_walk_batch)."""
    import numpy as np
    n = len(sources)
    ptrs = _src_ptrs(sources)
    lens = np.array([len(s) for s in sources], np.int64)
    cap_fse, cap_parts = 512, 1024
    while True:
        desc = np.empty((cap_fse, 20), np.int32)
        weights = np.empty((cap_fse, 360), np.uint16)
        parts = np.empty((cap_parts, 6), np.int32)
        cont_part_off = np.empty(n + 1, np.int32)
        cont_nraw = np.empty(n, np.int64)
        cont_ok = np.empty(n, np.int32)
        counts = np.empty(2, np.int64)
        rc = _lib().tl_walk_batch(
            ctypes.addressof(ptrs), lens.ctypes.data, n,
            desc.ctypes.data, weights.ctypes.data, cap_fse,
            parts.ctypes.data, cap_parts, cont_part_off.ctypes.data,
            cont_nraw.ctypes.data, cont_ok.ctypes.data,
            counts.ctypes.data)
        if rc == 0:
            nf, npts = int(counts[0]), int(counts[1])
            return (desc[:nf], weights[:nf], parts[:npts], cont_part_off,
                    cont_nraw, cont_ok)
        cap_fse *= 4
        cap_parts *= 4


def gather_payloads(sources, desc, dst_l, dst_m, stage) -> None:
    """Copy every FSE block's payloads from the source containers into the
    compact 512B-chunk staging buffer (replaces join+copy)."""
    ptrs = _src_ptrs(sources)
    _lib().tl_gather_payloads(ctypes.addressof(ptrs), desc.ctypes.data,
                              desc.shape[0], dst_l.ctypes.data,
                              dst_m.ctypes.data, stage.ctypes.data)


def alloc_reuse() -> None:
    """Tune glibc so freed large blocks stay in the arena (warm pages for
    the next batch's outputs). Serving-process opt-in; see tl_alloc_reuse."""
    _lib().tl_alloc_reuse()


def flatten_rebuild(lm_rows, d_rows, lit_rows, parts, cont_part_off,
                    out_offs, host_rows, host_lits, out, sources=(),
                    out_ptrs=None):
    """Flatten + LZ-rebuild a batch of containers in one threaded call.

    lm_rows/d_rows: (nb, LMDS) int32 packed device rows (l | m << 16 and
    raw d with repeat-zeros); lit_rows: (nb, LITS) uint8 (the kernels'
    packed literal words viewed as bytes); parts: (n_parts, 6) int32
    descriptors (kind 2/3 parts reference `sources`); cont_part_off:
    (n_conts+1,) int32; out_offs: (n_conts+1,) int64 output segment
    offsets; host_rows: (n_host_rows, 3) int32; host_lits: uint8; out:
    flat uint8 buffer; sources: the container bytes list (only needed
    when kind 2/3 parts are present); out_ptrs: optional (n_conts,)
    int64 array of per-container output base addresses — when given, each
    container rebuilds straight into its own buffer (the caller's final
    bytes objects) and `out` is ignored except as a dummy.
    Returns (n_conts,) int64 per-container bytes-written-or-negative-error.
    """
    import numpy as np
    # the C walker reads raw row-major memory
    lm_rows = np.ascontiguousarray(lm_rows, dtype=np.int32)
    d_rows = np.ascontiguousarray(d_rows, dtype=np.int32)
    lit_rows = np.ascontiguousarray(lit_rows, dtype=np.uint8)
    n_conts = len(out_offs) - 1
    status = np.empty(n_conts, np.int64)
    ptrs = _src_ptrs(list(sources) or [b""])
    # 2-D arrays: part row indices scale by the row stride. 1-D (dense
    # compacted) arrays: stride 1, so part indices are absolute word/byte
    # offsets.
    _lib().tl_flatten_rebuild(
        lm_rows.ctypes.data, d_rows.ctypes.data, lit_rows.ctypes.data,
        lm_rows.shape[1] if lm_rows.ndim == 2 else 1,
        lit_rows.shape[1] if lit_rows.ndim == 2 else 1,
        parts.ctypes.data, cont_part_off.ctypes.data, out_offs.ctypes.data,
        host_rows.ctypes.data, host_lits.ctypes.data, out.ctypes.data,
        status.ctypes.data, n_conts, lit_rows.size, host_lits.size,
        ctypes.addressof(ptrs),
        out_ptrs.ctypes.data if out_ptrs is not None else None)
    return status


def build_tables_batch(weights16, slots_v, slots_u, v_all, u_all) -> None:
    """Build every block's packed decode tables in one threaded call.

    weights16: (nb, 360) uint16 contiguous; slots_v/slots_u: (nb,) int32
    destination rows; v_all: (B, 384) int32; u_all: (B, 1024) int32.
    """
    import numpy as np
    assert weights16.dtype == np.uint16 and weights16.flags.c_contiguous
    _lib().tl_build_tables_batch(
        weights16.ctypes.data, slots_v.ctypes.data, slots_u.ctypes.data,
        weights16.shape[0], v_all.ctypes.data, u_all.ctypes.data)


def load_weights_v2(payload: bytes):
    """Decode a V2 weight payload into the 360 u16 weight table."""
    import numpy as np
    from ..base.errors import DecodeError
    w = np.zeros(360, dtype=np.uint16)
    rc = _lib().tl_load_weights_v2(payload, len(payload),
                                   w.ctypes.data)
    if rc != 0:
        raise DecodeError(f"bad weight payload: {rc}")
    return w.astype(np.int64)


def pack_groups(lo, meta, n_groups: int, shift: int) -> tuple[bytes, int]:
    """Pack a device-emitted tANS group stream (see ops/fse_encode.
    pack_group_stream) natively. Returns (payload bytes, leading pad bits)
    exactly as pack_group_stream."""
    import ctypes

    import numpy as np
    from ..base.errors import LzfseError
    lib = _lib()
    lo = np.ascontiguousarray(lo[:n_groups], np.int32)
    meta = np.ascontiguousarray(meta[:n_groups], np.int32)
    cap = n_groups * 8 + 16
    out = ctypes.create_string_buffer(cap)
    bits = lib.tl_pack_groups(
        lo.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p), n_groups, shift, out, cap)
    if bits < 0:
        raise LzfseError(f"pack_groups failed: {bits}")
    n_bytes = (int(bits) + 7) // 8
    return out.raw[:n_bytes], (8 - int(bits) % 8) % 8


def block_weights(rows3, lits):
    """Normalized weights (u16[N_WEIGHTS]) + V2 weight payload for one
    block's raw contents — native histogram + normalize_m1 +
    store_weights_v2 (byte-identical to spec.weights)."""
    import ctypes

    import numpy as np
    from ..base.errors import LzfseError
    lib = _lib()
    rows = np.ascontiguousarray(rows3, np.int32)
    lits = np.ascontiguousarray(lits, np.uint8)
    w = np.zeros(104 + 256, np.uint16)
    out = ctypes.create_string_buffer(712)
    n = lib.tl_block_weights(
        rows.ctypes.data_as(ctypes.c_void_p), rows.shape[0],
        lits.ctypes.data_as(ctypes.c_char_p), lits.shape[0],
        w.ctypes.data_as(ctypes.c_void_p), out, 712)
    if n < 0:
        raise LzfseError(f"block_weights failed: {n}")
    return w, out.raw[:n]


def frontend_blocks(src: bytes) -> bytes:
    """Native frontend (match finding + selection + block splitting) to raw
    block contents for the device emission plane. Same blob format as
    select_blocks; ctypes releases the GIL, so per-source calls parallelize
    across a thread pool."""
    import ctypes
    from ..base.errors import LzfseError
    lib = _lib()
    cap = len(src) + len(src) // 2 + 65536
    out = ctypes.create_string_buffer(cap)
    n = lib.tl_frontend_blocks(src, len(src), out, cap)
    if n < 0:
        raise LzfseError(f"frontend_blocks failed: {n}")
    return out.raw[:n]


def frontend_stage(src: bytes, bufs, counter, out_idx) -> int:
    """Fused native frontend + device-emission staging for one source:
    runs the history-table frontend and writes each closed block (and its
    period-split alt variant, when eligible) directly into the pooled
    staging arrays, reserving slots from the shared atomic `counter`.
    `bufs` is the (weights, litw, lit_num, lmv, dv, lmd_num, meta, wpay,
    wpay_len) tuple of C-contiguous numpy arrays; `out_idx` receives this
    source's base-block slot indices in block order. Returns the number of
    base blocks; raises LzfseError on pool overflow (caller retries with a
    bigger pool). Releases the GIL — sources stage in parallel."""
    import ctypes
    from ..base.errors import LzfseError
    weights, litw, lit_num, lmv, dv, lmd_num, meta, wpay, wpay_len = bufs
    lib = _lib()
    n = lib.tl_frontend_stage(
        src, len(src),
        weights.ctypes.data_as(ctypes.c_void_p),
        litw.ctypes.data_as(ctypes.c_void_p),
        lit_num.ctypes.data_as(ctypes.c_void_p),
        lmv.ctypes.data_as(ctypes.c_void_p),
        dv.ctypes.data_as(ctypes.c_void_p),
        lmd_num.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p),
        wpay.ctypes.data_as(ctypes.c_void_p),
        wpay_len.ctypes.data_as(ctypes.c_void_p),
        lmv.shape[1], weights.shape[0], wpay.shape[1],
        counter.ctypes.data_as(ctypes.c_void_p),
        out_idx.ctypes.data_as(ctypes.c_void_p), out_idx.shape[0])
    if n < 0:
        raise LzfseError(f"frontend_stage failed: {n}")
    return int(n)


PACK_SLOT_CAP = 163840  # >= 32 + 640 + 8*10112 lit + 8 + 8*10000 lmd bytes


def pack_stage(glo, gmeta, mlo, mmeta, lfs, mfs, lit_num, lmd_num, meta4,
               wpay, wpay_len, n_slots, arena, lens):
    """Batched pack + Vx2 body assembly for n_slots staged blocks into the
    fixed-stride arena (PACK_SLOT_CAP bytes per slot); lens[s] = body
    bytes. One native call, parallel across slots on the worker pool."""
    import ctypes
    from ..base.errors import LzfseError
    lib = _lib()
    vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.tl_pack_stage(
        vp(glo), vp(gmeta), vp(mlo), vp(mmeta), vp(lfs), vp(mfs),
        vp(lit_num), vp(lmd_num), vp(meta4), vp(wpay), vp(wpay_len),
        n_slots, glo.shape[1], wpay.shape[1], lfs.shape[1], mfs.shape[1],
        vp(arena), PACK_SLOT_CAP, vp(lens))
    if rc != 0:
        raise LzfseError(f"pack_stage failed: {rc}")


def match_group(src_pad, n_real: int, vn: bool):
    """Stable bucket grouping + candidate masks for one padded match
    window — the sort-free device frontend's host pass (tl_match_group,
    GIL-free: the linear counting sort reproduces the device path's
    stable argsort-by-bucket exactly, see find_matches_device). Returns
    (order int32[N] grouped positions, ok uint8[N] bitmasks: bit r-1 set
    when order[slot-r] is a valid candidate of order[slot])."""
    import ctypes
    import numpy as np
    lib = _lib()
    src_pad = np.ascontiguousarray(src_pad, dtype=np.uint8)
    N = len(src_pad)
    order = np.empty(N, np.int32)
    ok = np.empty(N, np.uint8)
    rc = lib.tl_match_group(
        src_pad.ctypes.data_as(ctypes.c_void_p), N, int(n_real),
        1 if vn else 0, order.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"tl_match_group failed: {rc}")
    return order, ok


def select_blocks(src: bytes, stream_rows):
    """Selection + FSE block splitting WITHOUT emission: returns the raw
    block contents for the device emission plane. Serialized per block as
    u32 n_lit, u32 n_lmd, u32 n_match_bytes, lits[n_lit], then n_lmd
    packed rows (u16 l, u16 m, u32 d with repeat-distance zeros)."""
    import ctypes
    import numpy as np
    from ..base.errors import LzfseError
    lib = _lib()
    rows = np.ascontiguousarray(stream_rows, dtype=np.int64)
    cap = len(src) + len(src) // 2 + 65536
    out = ctypes.create_string_buffer(cap)
    n = lib.tl_select_blocks(
        src, len(src), rows.ctypes.data_as(ctypes.c_void_p), rows.shape[0],
        out, cap)
    if n < 0:
        raise LzfseError(f"select_blocks failed: {n}")
    return out.raw[:n]


class StreamDecoder:
    """Constant-memory incremental container decoder (native engine).

    push(data) feeds compressed bytes and returns how many were consumed
    (less than len(data) only under output backpressure — drain with pull).
    pull(cap) returns up to cap decoded bytes (b"" when drained).
    finish() validates that a complete container (through EOS) was consumed.

    The native stream keeps O(1) state: one bounded FSE block carry plus a
    1 MiB output ring (tpulzfse.cpp StreamDec; the reference counterpart is
    ReaderCore::fill, src/decode/reader_core.rs:56-99).
    """

    def __init__(self):
        import ctypes
        self._ct = ctypes
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.tl_stream_new()
        self._buf = ctypes.create_string_buffer(1 << 16)

    def push(self, data: bytes) -> int:
        from ..base.errors import DecodeError
        n = self._lib.tl_stream_push(self._h, data, len(data))
        if n < 0:
            raise DecodeError(f"stream decode failed: {n}")
        return int(n)

    def pull(self, cap: int | None = None) -> bytes:
        from ..base.errors import DecodeError
        cap = min(cap or (1 << 16), 1 << 16)
        n = self._lib.tl_stream_pull(self._h, self._buf, cap)
        if n < 0:
            raise DecodeError(f"stream decode failed: {n}")
        return self._buf.raw[:n]

    def finish(self) -> None:
        from ..base.errors import DecodeError
        rc = self._lib.tl_stream_finish(self._h)
        if rc != 0:
            raise DecodeError(f"stream finish failed: {rc}")

    def close(self) -> None:
        if self._h:
            self._lib.tl_stream_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class StreamEncoder:
    """Sliding-window incremental encoder (native engine).

    Matches reach the format's maximum distance (262139 bytes) back across
    chunk boundaries — the reference ring encoder's Goldilocks semantics
    (src/encode/frontend_ring.rs:44-106) — and FSE blocks span chunk
    boundaries. Memory is O(window + one block). Drain with pull() between
    pushes; finish() flushes the final block and the EOS magic.
    """

    def __init__(self):
        import ctypes
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.tl_enc_new()
        self._buf = ctypes.create_string_buffer(1 << 18)

    def push(self, data: bytes) -> int:
        from ..base.errors import LzfseError
        n = self._lib.tl_enc_push(self._h, data, len(data))
        if n < 0:
            raise LzfseError(f"stream encode failed: {n}")
        return int(n)

    def pull(self, cap: int | None = None) -> bytes:
        cap = min(cap or (1 << 18), 1 << 18)
        n = self._lib.tl_enc_drain(self._h, self._buf, cap)
        return self._buf.raw[:n] if n > 0 else b""

    def finish(self) -> None:
        self._lib.tl_enc_finish(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.tl_enc_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def rebuild(rows, literals: bytes, n_out: int) -> bytes:
    """LZ reconstruction from (l, m, d) int32 rows + a literal pool."""
    import ctypes
    import numpy as np
    from ..base.errors import DecodeError
    lib = _lib()
    r = np.ascontiguousarray(rows, dtype=np.int32)
    out = np.empty(max(n_out, 1), dtype=np.uint8)
    n = lib.tl_rebuild(r.ctypes.data_as(ctypes.c_void_p), r.shape[0],
                       literals, len(literals),
                       out.ctypes.data_as(ctypes.c_char_p), n_out)
    if n < 0:
        raise DecodeError(f"rebuild failed: {n}")
    return out[:n].tobytes()
