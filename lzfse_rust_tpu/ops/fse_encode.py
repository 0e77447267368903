"""Batched tANS encode — device groundwork for the all-device encode plane.

The reverse-order encode (literals.rs:93-133, lmds.rs:62-93) evolves a
per-stream state backwards over the symbol list; each symbol's emitted bit
count depends on the evolving state:

    n_bits = (t_k[sym] + state) >> 10 ;  state' = t_w[sym] + (state >> n_bits)

This module provides the batched building blocks:
  * build_encode_tables — all blocks' per-symbol E tables at once
    (encoder.rs:219-240 vectorized), packed one int32 per entry
  * encode_literals_batch — 4-lane reverse state scan emitting
    (bits, n_bits) per step, one lax.scan step per 4 symbols
  * encode_lmds_batch — 3-lane reverse LMD scan emitting the six
    (bits, n_bits) pushes per row in exact stream order

Bit PACKING (turning the (bits, n_bits) stream into payload bytes) runs on
the host: positions are an exclusive prefix sum of n_bits and the packing
is a short numpy pass. These scans are the plain reference for the GPU
emission kernels (ops/tans_gpu.py) and are validated byte-identical to the
spec encoder's payloads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..base import constants as C


def _bit_length(w):
    return 32 - jax.lax.clz(w.astype(jnp.int32))


def _build_e_block(w: jnp.ndarray, n_states: int) -> jnp.ndarray:
    """(B, S) weights -> (B, S) packed int32 ((t_k + 2048) | t_w << 15)."""
    n_bits = n_states.bit_length() - 1
    cum_exc = jnp.cumsum(w, axis=1) - w
    k = (n_bits + 1) - _bit_length(jnp.maximum(w, 1))
    t_k = jnp.where(w == 0, -n_states, 1024 * k - (w << k))
    t_w = jnp.where(w == 0, 0, n_states + cum_exc - w)
    return (t_k + 2048) | (t_w << 15)


@jax.jit
def build_encode_tables(weights: jnp.ndarray):
    """weights: (B, 360) -> packed E tables (e_l (B,20), e_m (B,20),
    e_d (B,64), e_u (B,256))."""
    return (_build_e_block(weights[:, :C.L_TOP], C.L_STATES),
            _build_e_block(weights[:, C.L_TOP:C.M_TOP], C.M_STATES),
            _build_e_block(weights[:, C.M_TOP:C.D_TOP], C.D_STATES),
            _build_e_block(weights[:, C.D_TOP:C.U_TOP], C.U_STATES))


@functools.partial(jax.jit, static_argnames=("n_steps",))
def encode_literals_batch(e_u: jnp.ndarray, literals: jnp.ndarray,
                          num: jnp.ndarray, n_steps: int):
    """Reverse 4-lane literal state evolution.

    e_u: (B, 256) packed; literals: (B, n_steps*4) uint8 padded (multiple of
    4 per block); num: (B,) literal counts. Emits per step the 4 lanes'
    (state_bits, n_bits) in REVERSE stream order (lane 3 first, matching
    literals.rs:110-121), plus final states (which the header stores).
    """
    B = e_u.shape[0]
    lits = literals.astype(jnp.int32)

    def one(s, sym, active):
        e = jnp.take_along_axis(e_u, sym[:, None], axis=1)[:, 0]
        t_k = (e & 0x7FFF) - 2048
        t_w = e >> 15
        n_bits = (t_k + s) >> 10
        bits = s & ((1 << n_bits) - 1)
        s_new = jnp.where(active, t_w + (s >> n_bits), s)
        return s_new, jnp.where(active, bits, 0), jnp.where(active, n_bits, 0)

    def step(carry, i):
        s0, s1, s2, s3 = carry
        # reverse traversal: group g covers literals [4g, 4g+4) taken from
        # the tail; active while the group index is inside this block's count
        g = (num >> 2) - 1 - i
        active = g >= 0
        base = jnp.maximum(g * 4, 0)
        sym = [jnp.take_along_axis(lits, (base + t)[:, None], axis=1)[:, 0]
               for t in range(4)]
        s3, b3, n3 = one(s3, sym[3], active)
        s2, b2, n2 = one(s2, sym[2], active)
        s1, b1, n1 = one(s1, sym[1], active)
        s0, b0, n0 = one(s0, sym[0], active)
        out = jnp.stack([b3, n3, b2, n2, b1, n1, b0, n0], axis=1)
        return (s0, s1, s2, s3), out

    init = tuple(jnp.full((B,), C.U_STATES, jnp.int32) for _ in range(4))
    (s0, s1, s2, s3), outs = jax.lax.scan(
        step, init, jnp.arange(n_steps, dtype=jnp.int32))
    states = jnp.stack([s0, s1, s2, s3], axis=1) - C.U_STATES
    return jnp.transpose(outs, (1, 0, 2)), states


def pack_bits_host(stream: np.ndarray) -> tuple[bytes, int]:
    """Pack an (n, 2) [(bits, n_bits), ...] push stream into payload bytes.

    Returns (payload, off). Positions are the exclusive prefix sum of
    n_bits; a vectorized numpy pass ORs each value's contribution into up to
    four bytes (n_bits <= 25 at shift <= 7).
    """
    bits = stream[:, 0].astype(np.uint64)
    nb = stream[:, 1].astype(np.int64)
    pos = np.concatenate([[0], np.cumsum(nb)])
    total = int(pos[-1])
    n_bytes = (total + 7) // 8
    off = (8 - total % 8) % 8
    buf = np.zeros(n_bytes + 8, dtype=np.uint8)
    byte0 = (pos[:-1] >> 3).astype(np.int64)
    sh = (pos[:-1] & 7).astype(np.uint64)
    v = bits << sh
    for k in range(5):  # up to 25 bits + 7 shift spans 4 bytes; one spare
        np.bitwise_or.at(buf, byte0 + k, ((v >> np.uint64(8 * k))
                                          & np.uint64(0xFF)).astype(np.uint8))
    return buf[:n_bytes].tobytes(), off


def pack_group_stream(lo: np.ndarray, meta: np.ndarray, n_groups: int,
                      meta_shift: int) -> tuple[bytes, int]:
    """Pack one block's emission-kernel group stream into payload bytes.

    lo/meta: int32 columns from ops/tans_gpu (one entry per push
    group, forward payload order); meta = hi | n << meta_shift where the
    group value is lo (u32) | hi << 32 with n total bits (<= 54).
    Returns (payload, off) exactly as pack_bits_host.
    """
    lo64 = lo[:n_groups].astype(np.uint64) & np.uint64(0xFFFFFFFF)
    m = meta[:n_groups].astype(np.int64)
    hi = (m & ((1 << meta_shift) - 1)).astype(np.uint64)
    nb = (m >> meta_shift).astype(np.int64)
    val = lo64 | (hi << np.uint64(32))
    pos = np.concatenate([[0], np.cumsum(nb)])
    total = int(pos[-1])
    n_bytes = (total + 7) // 8
    off = (8 - total % 8) % 8
    buf = np.zeros(n_bytes + 9, dtype=np.uint8)
    byte0 = (pos[:-1] >> 3).astype(np.int64)
    sh = (pos[:-1] & 7).astype(np.uint64)
    v = val << sh  # <= 54 + 7 = 61 bits
    for k in range(8):
        np.bitwise_or.at(buf, byte0 + k, ((v >> np.uint64(8 * k))
                                          & np.uint64(0xFF)).astype(np.uint8))
    return buf[:n_bytes].tobytes(), off


@functools.partial(jax.jit, static_argnames=("n_steps",))
def encode_lmds_batch(e_l: jnp.ndarray, e_m: jnp.ndarray, e_d: jnp.ndarray,
                      lmds: jnp.ndarray, num: jnp.ndarray, n_steps: int):
    """Reverse 3-lane LMD state evolution (lmds.rs:62-93).

    lmds: (B, n_steps, 3) packed (l, m, d) rows; num: (B,) row counts.
    Emits per step six (bits, n_bits) pairs in push order — d extra, d
    state, m extra, m state, l extra, l state — plus final (L, M, D) states.
    """
    B = e_l.shape[0]
    l_sym_t = jnp.asarray(C.L_BASE_FROM_VALUE)
    m_sym_t = jnp.asarray(C.M_BASE_FROM_VALUE)
    d_sym_t = jnp.asarray(C.D_BASE_FROM_VALUE)
    l_extra = jnp.asarray(C.L_EXTRA_BITS)
    m_extra = jnp.asarray(C.M_EXTRA_BITS)
    d_extra = jnp.asarray(C.D_EXTRA_BITS)
    l_base = jnp.asarray(C.L_BASE_VALUE)
    m_base = jnp.asarray(C.M_BASE_VALUE)
    d_base = jnp.asarray(C.D_BASE_VALUE)

    def d_index(v):
        return jnp.where(
            v < 60, v,
            jnp.where(v < 1020, ((v - 60) >> 4) + 64,
                      jnp.where(v < 16380, ((v - 1020) >> 8) + 128,
                                ((v - 16380) >> 12) + 192)))

    def one(e_tab, s, sym, active):
        e = jnp.take_along_axis(e_tab, sym[:, None], axis=1)[:, 0]
        t_k = (e & 0x7FFF) - 2048
        t_w = e >> 15
        n_bits = (t_k + s) >> 10
        bits = s & ((1 << n_bits) - 1)
        s_new = jnp.where(active, t_w + (s >> n_bits), s)
        return s_new, jnp.where(active, bits, 0), jnp.where(active, n_bits, 0)

    def step(carry, i):
        sl, sm, sd = carry
        r = num - 1 - i
        active = r >= 0
        safe = jnp.maximum(r, 0)
        row = jnp.take_along_axis(lmds, safe[:, None, None], axis=1)[:, 0, :]
        l, m, d = row[:, 0], row[:, 1], row[:, 2]
        d_i = d_index(d)
        ds = jnp.take(d_sym_t, d_i)
        d_eb = jnp.take(d_extra, ds)
        d_ex = d - jnp.take(d_base, ds)
        sd, db, dn = one(e_d, sd, ds, active)
        ms = jnp.take(m_sym_t, m)
        m_eb = jnp.take(m_extra, ms)
        m_ex = m - jnp.take(m_base, ms)
        sm, mb, mn = one(e_m, sm, ms, active)
        ls = jnp.take(l_sym_t, l)
        l_eb = jnp.take(l_extra, ls)
        l_ex = l - jnp.take(l_base, ls)
        sl, lb, ln = one(e_l, sl, ls, active)
        z = jnp.where(active, 1, 0)
        out = jnp.stack([d_ex * z, d_eb * z, db, dn,
                         m_ex * z, m_eb * z, mb, mn,
                         l_ex * z, l_eb * z, lb, ln], axis=1)
        return (sl, sm, sd), out

    init = (jnp.full((B,), C.L_STATES, jnp.int32),
            jnp.full((B,), C.M_STATES, jnp.int32),
            jnp.full((B,), C.D_STATES, jnp.int32))
    (sl, sm, sd), outs = jax.lax.scan(
        step, init, jnp.arange(n_steps, dtype=jnp.int32))
    states = jnp.stack([sl - C.L_STATES, sm - C.M_STATES, sd - C.D_STATES],
                       axis=1)
    return jnp.transpose(outs, (1, 0, 2)), states
