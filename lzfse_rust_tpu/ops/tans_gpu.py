"""GPU tANS kernels: batched FSE block decode and emission (Pallas, Triton).

Every FSE stream is a serial chain: up to 10,000 steps (base/constants.py
LMDS_PER_BLOCK) whose table lookups and variable-width bit reads each depend
on the previous step. XLA runs such a chain (ops/fse_decode.py,
ops/fse_encode.py) as a device while-loop with kernel launches per step;
here one GPU thread owns one FSE block for its whole chain:

  - a kernel program is one warp of LANES blocks; its states and bit
    position live in registers, and it loops to the longest chain among
    its lanes (the wrappers sort blocks by chain length, so a warp's lanes
    finish together);
  - tables are read through L1 with one load per state: the packed
    per-state entries of ops/table_build.build_decode_tables (U: 1024,
    V: 384 words per block) and the E entries of
    ops/fse_encode.build_encode_tables;
  - the decoders read each payload straight from the packed upload (one
    flat uint32 array, every payload starting at a word boundary) and write
    each block's output at its own dense offset, so nothing is padded to
    the format's per-block maximum on the way in or out.

The arithmetic is the spec layer's (spec/fse.py); the XLA scans are the
plain reference and must agree exactly (integers only, no tolerance).
Callers pick between the two by backend (select_path); `interpret=True`
runs a kernel through the Pallas interpreter and is for tests on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..base import constants as C

LANES = 32  # FSE blocks per kernel program: one warp, one block per thread

# Set by tests to run the kernels through the Pallas interpreter on the CPU.
INTERPRET = False


def select_path(backend: str | None = None) -> str:
    """The entropy-coding path for a JAX backend: "gpu" runs these kernels,
    "cpu" the XLA scans. Any other backend has no path and raises."""
    backend = backend or jax.default_backend()
    if backend in ("gpu", "cpu"):
        return backend
    raise RuntimeError(f"no tANS path for JAX backend {backend!r}")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _lanes():
    return pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)


def _call(kernel, n_lanes: int, out_shape, name: str, interpret: bool):
    return pl.pallas_call(
        kernel, grid=(n_lanes // LANES,), out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret, name=name)


def _lane_params(steps, cols):
    """Per-lane parameter table, blocks sorted by chain length (longest
    first). Column 0 is the block index; padding lanes get indices past the
    last block and zero steps. Returns (params (Bp, 1+len(cols)), Bp)."""
    B = steps.shape[0]
    Bp = _round_up(max(B, 1), LANES)
    order = jnp.argsort(-steps, stable=True).astype(jnp.int32)
    pad = Bp - B
    cols = [jnp.pad(c.astype(jnp.int32)[order], (0, pad)) for c in cols]
    ids = jnp.concatenate([order, jnp.arange(B, Bp, dtype=jnp.int32)])
    return jnp.stack([ids] + cols, axis=1), Bp


def _read(w_ref, base, p, n):
    """n (< 32) stream bits at bit position p of the payload whose first
    word is w_ref[base]; zero below bit 0 (src/bits/bit_src.rs:35-45)."""
    pc = jnp.maximum(p, 0)
    wi = base + (pc >> 5)
    lo = w_ref[wi]
    hi = w_ref[wi + 1]
    sh = (pc & 31).astype(jnp.uint32)
    v = (lo >> sh) | ((hi << jnp.uint32(1)) << (jnp.uint32(31) - sh))
    bits = v & ((jnp.uint32(1) << n.astype(jnp.uint32)) - jnp.uint32(1))
    return jnp.where(p < 0, 0, bits.astype(jnp.int32))


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def _lit_decode_kernel(tab_ref, w_ref, par_ref, out_ref, fin_ref, *, n_rows,
                       n_out):
    lane = _lanes()
    blk = par_ref[lane, 0]
    base = par_ref[lane, 1]
    steps = par_ref[lane, 3]
    off = par_ref[lane, 4]
    tab = jnp.minimum(blk, n_rows - 1) * C.U_STATES
    init = tuple(par_ref[lane, 5 + j] & (C.U_STATES - 1) for j in range(4))

    def body(i, carry):
        *s, pos = carry
        active = i < steps
        p = pos
        word = jnp.zeros(LANES, jnp.uint32)
        new = []
        for j in range(4):
            e = tab_ref[tab + s[j]]
            k = e & 15
            p = p - k
            new.append(jnp.where(active, _read(w_ref, base, p, k) + (e >> 12),
                                 s[j]))
            word = word | (((e >> 4) & 255).astype(jnp.uint32) << (8 * j))
        plt.store(out_ref.at[jnp.where(active, off + i, n_out - 1)], word,
                  mask=active)
        return (*new, jnp.where(active, p, pos))

    *s, pos = jax.lax.fori_loop(0, jnp.max(steps), body,
                                (*init, par_ref[lane, 2]))
    for j in range(4):
        plt.store(fin_ref.at[blk, j], s[j])
    plt.store(fin_ref.at[blk, 4], pos)


@functools.partial(jax.jit, static_argnames=("n_out", "interpret"))
def decode_literals(u_tab, words, base, pos, states, num, out_off, *,
                    n_out: int, interpret: bool = False):
    """Batched 4-state literal decode, one thread per block.

    u_tab: (B, 1024) int32 packed U entries (k | sym << 4 | delta << 12);
    words: (W,) uint32, the packed payloads (block b's literal payload,
    with its 8 leading bytes, starts at word base[b] and is followed by at
    least one readable word); pos: (B,) initial bit positions; states:
    (B, 4); num: (B,) literal counts; out_off: (B,) output word offsets.
    Returns (literals (n_out,) uint32 — block b's ceil(num/4) words of four
    little-endian literals at out_off[b]; final (B, 5) int32 — the four
    states, then the bit position). The last output word is scratch (lanes
    whose chain has ended aim their masked stores there), so n_out must
    exceed the words the blocks fill."""
    B = u_tab.shape[0]
    steps = (num + 3) >> 2
    par, Bp = _lane_params(steps, [base, pos, steps, out_off,
                                   *(states[:, j] for j in range(4))])
    kern = functools.partial(_lit_decode_kernel, n_rows=B, n_out=n_out)
    out, fin = _call(kern, Bp, (jax.ShapeDtypeStruct((n_out,), jnp.uint32),
                                jax.ShapeDtypeStruct((Bp, 5), jnp.int32)),
                     "tans_decode_literals", interpret)(
        u_tab.reshape(-1), words, par)
    return out, fin[:B]


def _lmd_decode_kernel(tab_ref, w_ref, par_ref, lm_ref, d_ref, fin_ref, *,
                       n_rows, n_out):
    lane = _lanes()
    blk = par_ref[lane, 0]
    base = par_ref[lane, 1]
    steps = par_ref[lane, 3]
    off = par_ref[lane, 4]
    tab = jnp.minimum(blk, n_rows - 1) * 384
    init = tuple(jnp.clip(par_ref[lane, 5 + c], 0, 383) for c in range(3))

    def body(i, carry):
        *s, pos = carry
        active = i < steps
        p = pos
        vals = []
        new = []
        for c in range(3):  # L, M, D: k state bits, then v_bits value bits
            e = tab_ref[tab + s[c]]
            k = e & 15
            nb = (e >> 4) & 15
            hi = (e >> 17) & 0x7FFF
            p = p - k
            sbits = _read(w_ref, base, p, k)
            p = p - nb
            vbits = _read(w_ref, base, p, nb)
            if c == 2:  # the D lane packs its symbol j: base(j) in closed form
                hi = ((4 + (hi & 3)) << (hi >> 2)) - 4
            vals.append(hi + vbits)
            new.append(jnp.where(active, sbits + ((e >> 8) & 0x1FF), s[c]))
        dst = jnp.where(active, off + i, n_out - 1)
        plt.store(lm_ref.at[dst], vals[0] | (vals[1] << 16), mask=active)
        plt.store(d_ref.at[dst], vals[2], mask=active)
        return (*new, jnp.where(active, p, pos))

    *s, pos = jax.lax.fori_loop(0, jnp.max(steps), body,
                                (*init, par_ref[lane, 2]))
    for c in range(3):
        plt.store(fin_ref.at[blk, c], s[c])
    plt.store(fin_ref.at[blk, 3], pos)


@functools.partial(jax.jit, static_argnames=("n_out", "interpret"))
def decode_lmds(v_tab, words, base, pos, states, num, out_off, *,
                n_out: int, interpret: bool = False):
    """Batched 3-state L/M/D decode, one thread per block.

    v_tab: (B, 384) int32 packed V entries (k | v_bits << 4 | delta << 8 |
    hi << 17, hi = value base for L/M, D symbol for D); states: (B, 3)
    compound-table states (L at +0, M at +64, D at +128); other arguments
    as decode_literals. Returns (lm (n_out,) int32 = l | m << 16,
    d (n_out,) int32 raw distances, final (B, 4) int32 — three states,
    then the bit position); block b's num rows sit at out_off[b], and the
    last output row is scratch as in decode_literals."""
    B = v_tab.shape[0]
    par, Bp = _lane_params(num, [base, pos, num, out_off,
                                 *(states[:, c] for c in range(3))])
    kern = functools.partial(_lmd_decode_kernel, n_rows=B, n_out=n_out)
    lm, d, fin = _call(kern, Bp,
                       (jax.ShapeDtypeStruct((n_out,), jnp.int32),
                        jax.ShapeDtypeStruct((n_out,), jnp.int32),
                        jax.ShapeDtypeStruct((Bp, 4), jnp.int32)),
                       "tans_decode_lmds", interpret)(
        v_tab.reshape(-1), words, par)
    return lm, d, fin[:B]


# --------------------------------------------------------------------------
# Emission (encode)
# --------------------------------------------------------------------------

def _push(acc, b, n):
    """Append the n-bit value b above the (lo, hi, sh) bit accumulator
    (pieces are < 32 bits, totals < 64)."""
    lo, hi, sh = acc
    b = b.astype(jnp.uint32)
    shl = jnp.minimum(sh, 31).astype(jnp.uint32)
    lo = lo | jnp.where(sh < 32, b << shl, jnp.uint32(0))
    hi = hi | jnp.where(
        sh >= 32, b << jnp.clip(sh - 32, 0, 31).astype(jnp.uint32),
        (b >> jnp.uint32(1)) >> (jnp.uint32(31) - shl))
    return lo, hi, sh + n


def _e_step(e, s, active):
    """Packed E entry ((t_k + 2048) | t_w << 15) -> (bits, n_bits, s')."""
    nb = jnp.clip(((e & 0x7FFF) - 2048 + s) >> 10, 0, 31)
    bits = s & ((1 << nb) - 1)
    return bits, nb, jnp.where(active, (e >> 15) + (s >> nb), s)


def _lit_encode_kernel(tab_ref, w_ref, par_ref, lo_ref, meta_ref, fin_ref, *,
                       n_rows, n_cols):
    lane = _lanes()
    blk = par_ref[lane, 0]
    groups = par_ref[lane, 1]
    row = jnp.minimum(blk, n_rows - 1)
    tab = row * C.U_SYMBOLS
    init = tuple(jnp.full(LANES, C.U_STATES, jnp.int32) for _ in range(4))

    def body(g, s):
        active = g < groups
        wd = w_ref[row * n_cols + (n_cols - 1 - g)]
        s = list(s)
        acc = (jnp.zeros(LANES, jnp.uint32), jnp.zeros(LANES, jnp.uint32),
               jnp.zeros(LANES, jnp.int32))
        for j in (3, 2, 1, 0):  # lane 3 pushes first (literals.rs:110-121)
            sym = (wd >> (8 * j)) & 255
            bits, nb, s[j] = _e_step(tab_ref[tab + sym], s[j], active)
            acc = _push(acc, bits, nb)
        lo, hi, n = acc
        dst = blk * n_cols + g
        plt.store(lo_ref.at[dst], lo.astype(jnp.int32), mask=active)
        plt.store(meta_ref.at[dst], hi.astype(jnp.int32) | (n << 8),
                  mask=active)
        return tuple(s)

    s = jax.lax.fori_loop(0, jnp.max(groups), body, init)
    for j in range(4):
        plt.store(fin_ref.at[blk, j], s[j])


@functools.partial(jax.jit, static_argnames=("interpret",))
def encode_literals(e_u, words, num, *, interpret: bool = False):
    """Batched 4-state literal emission, one thread per block.

    e_u: (B, 256) packed E entries; words: (B, n_cols) int32, four
    literals per word, RIGHT-JUSTIFIED (a block's last group in the last
    column); num: (B,) literal counts (multiples of 4). Returns
    (lo, meta (B, n_cols) int32, final (B, 4) int32 states): column g holds
    push group g in forward payload order as the 64-bit value
    lo | (meta & 0xFF) << 32 of meta >> 8 bits (ops/fse_encode.
    pack_group_stream, shift 8)."""
    B, n_cols = words.shape
    groups = num >> 2
    par, Bp = _lane_params(groups, [groups])
    kern = functools.partial(_lit_encode_kernel, n_rows=B, n_cols=n_cols)
    lo, meta, fin = _call(kern, Bp,
                          (jax.ShapeDtypeStruct((B * n_cols,), jnp.int32),
                           jax.ShapeDtypeStruct((B * n_cols,), jnp.int32),
                           jax.ShapeDtypeStruct((Bp, 4), jnp.int32)),
                          "tans_encode_literals", interpret)(
        e_u.reshape(-1), words.reshape(-1), par)
    return lo.reshape(B, n_cols), meta.reshape(B, n_cols), fin[:B]


def _lmd_consts() -> np.ndarray:
    """(384,) int32: per class symbol (extra_bits | base << 4) at L 0,
    M 32, D 64, then the 256-entry D symbol-from-fine-index table."""
    pk = np.zeros(128, np.int64)
    pk[:20] = C.L_EXTRA_BITS | (C.L_BASE_VALUE.astype(np.int64) << 4)
    pk[32:52] = C.M_EXTRA_BITS | (C.M_BASE_VALUE.astype(np.int64) << 4)
    pk[64:128] = C.D_EXTRA_BITS | (C.D_BASE_VALUE.astype(np.int64) << 4)
    return np.concatenate([pk, C.D_BASE_FROM_VALUE]).astype(np.int32)


def _d_index(v):
    return jnp.where(
        v < 60, v,
        jnp.where(v < 1020, ((v - 60) >> 4) + 64,
                  jnp.where(v < 16380, ((v - 1020) >> 8) + 128,
                            ((v - 16380) >> 12) + 192)))


def _lmd_encode_kernel(tab_ref, lm_ref, d_ref, k_ref, par_ref, lo_ref,
                       meta_ref, fin_ref, *, n_rows, n_cols):
    lane = _lanes()
    blk = par_ref[lane, 0]
    rows = par_ref[lane, 1]
    row = jnp.minimum(blk, n_rows - 1)
    init = (jnp.full(LANES, C.L_STATES, jnp.int32),
            jnp.full(LANES, C.M_STATES, jnp.int32),
            jnp.full(LANES, C.D_STATES, jnp.int32))

    def body(g, s):
        active = g < rows
        src = row * n_cols + (n_cols - 1 - g)
        lm = lm_ref[src]
        d = d_ref[src]
        l = lm & 0xFFFF
        m = (lm >> 16) & 0xFFFF
        # L/M symbols by threshold counting (bases 16, 20|24, 28|56, 60|312)
        sym_l = jnp.where(l < 16, l, 16 + (l >= 20).astype(jnp.int32)
                          + (l >= 28).astype(jnp.int32)
                          + (l >= 60).astype(jnp.int32))
        sym_m = jnp.where(m < 16, m, 16 + (m >= 24).astype(jnp.int32)
                          + (m >= 56).astype(jnp.int32)
                          + (m >= 312).astype(jnp.int32))
        sym_d = k_ref[128 + jnp.clip(_d_index(d), 0, 255)]
        s = list(s)
        acc = (jnp.zeros(LANES, jnp.uint32), jnp.zeros(LANES, jnp.uint32),
               jnp.zeros(LANES, jnp.int32))
        # push order d, m, l; each pair is (extra bits, then state bits)
        for c, v, sym, cls in ((2, d, sym_d, 64), (1, m, sym_m, 32),
                               (0, l, sym_l, 0)):
            pk = k_ref[cls + sym]
            eb = pk & 15
            bits, nb, s[c] = _e_step(tab_ref[row * 128 + cls + sym], s[c],
                                     active)
            acc = _push(acc, (v - (pk >> 4)) | (bits << eb), eb + nb)
        lo, hi, n = acc
        dst = blk * n_cols + g
        plt.store(lo_ref.at[dst], lo.astype(jnp.int32), mask=active)
        plt.store(meta_ref.at[dst], hi.astype(jnp.int32) | (n << 22),
                  mask=active)
        return tuple(s)

    s = jax.lax.fori_loop(0, jnp.max(rows), body, init)
    for c in range(3):
        plt.store(fin_ref.at[blk, c], s[c])


@functools.partial(jax.jit, static_argnames=("interpret",))
def encode_lmds(e_l, e_m, e_d, lm, d, num, *, interpret: bool = False):
    """Batched 3-state L/M/D emission, one thread per block.

    e_l/e_m/e_d: (B, 20/20/64) packed E entries; lm: (B, n_cols) int32
    l | m << 16 rows and d: (B, n_cols) distances, RIGHT-JUSTIFIED;
    num: (B,) row counts. Returns (lo, meta (B, n_cols) int32, final (B, 3)
    int32 L/M/D states); meta = hi | n << 22 (pack_group_stream, shift
    22)."""
    B, n_cols = lm.shape
    tab = jnp.zeros((B, 128), jnp.int32)
    tab = tab.at[:, :20].set(e_l).at[:, 32:52].set(e_m).at[:, 64:].set(e_d)
    par, Bp = _lane_params(num, [num])
    kern = functools.partial(_lmd_encode_kernel, n_rows=B, n_cols=n_cols)
    lo, meta, fin = _call(kern, Bp,
                          (jax.ShapeDtypeStruct((B * n_cols,), jnp.int32),
                           jax.ShapeDtypeStruct((B * n_cols,), jnp.int32),
                           jax.ShapeDtypeStruct((Bp, 3), jnp.int32)),
                          "tans_encode_lmds", interpret)(
        tab.reshape(-1), lm.reshape(-1), d.reshape(-1),
        jnp.asarray(_lmd_consts()), par)
    return lo.reshape(B, n_cols), meta.reshape(B, n_cols), fin[:B]
