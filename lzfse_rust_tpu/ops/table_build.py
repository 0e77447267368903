"""Batched tANS decode-table construction on device.

Where the reference builds tables with a sequential per-symbol scatter loop
(src/fse/decoder.rs:244-335), this builds all four tables for a whole batch of
blocks at once with cumulative sums + searchsorted: state s belongs to the
symbol whose cumulative-weight interval contains s, and the intra-symbol rank
j = s - cum[sym] determines (k, delta) exactly as the reference's inner loops
do. States beyond the normalized total become self-latching entries
(decoder.rs:283-291) so malformed inputs converge to a detectable state.

Table representations (int32, batch-leading):
  v_tab: (B, 384, 4)  columns k, v_bits, delta, v_base  -- L|M|D states
  u_tab: (B, 1024, 3) columns k, symbol, delta
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..base import constants as C


def _bit_length(w: jnp.ndarray) -> jnp.ndarray:
    """32 - clz(w) for int32 w >= 0."""
    return 32 - jax.lax.clz(w.astype(jnp.int32))


def _build_block(w: jnp.ndarray, n_states: int, offset: int,
                 sym_a: jnp.ndarray, sym_b: jnp.ndarray,
                 latch_a: int, latch_b_is_state: bool):
    """Build one class's decode table rows for a batch.

    w: (B, S) weights. Returns (k, a, delta) each (B, n_states) where `a` is
    v_bits/v_base packed later by the caller via sym_a/sym_b gathers:
    sym_a/sym_b are per-symbol attribute vectors (e.g. extra-bits and base
    values for V tables; symbol index and zeros for U tables).
    """
    B, S = w.shape
    n_bits = int(np.log2(n_states))
    cum_inc = jnp.cumsum(w, axis=1)                      # inclusive
    cum_exc = cum_inc - w                                # exclusive
    total = cum_inc[:, -1]
    states = jnp.arange(n_states, dtype=jnp.int32)
    # Symbol owning each state: count of cum_inc <= s, via batched binary
    # search (log2(S) compare rounds instead of an S x n_states compare
    # matrix — the matrix was ~25x more work at U size and dominated the
    # batched table build).
    sym = jax.vmap(
        lambda c: jnp.searchsorted(c, states, side="right").astype(jnp.int32)
    )(cum_inc)
    sym = jnp.minimum(sym, S - 1)
    wsym = jnp.take_along_axis(w, sym, axis=1)           # (B, n_states)
    j = states[None, :] - jnp.take_along_axis(cum_exc, sym, axis=1)
    k = (n_bits + 1) - _bit_length(jnp.maximum(wsym, 1))
    x = ((n_states << 1) >> k) - wsym
    in_head = j < x
    k_e = jnp.where(in_head, k, k - 1)
    delta = jnp.where(in_head,
                      ((wsym + j) << k) - n_states,
                      (j - x) << jnp.maximum(k - 1, 0)) + offset
    a_e = jnp.take_along_axis(sym_a[None, :].repeat(B, 0), sym, axis=1)
    b_e = jnp.take_along_axis(sym_b[None, :].repeat(B, 0), sym, axis=1)
    # latch entries for states >= total
    valid = states[None, :] < total[:, None]
    k_e = jnp.where(valid, k_e, 0)
    a_e = jnp.where(valid, a_e, latch_a)
    b_e = jnp.where(valid, b_e, 0 if not latch_b_is_state else 0)
    delta = jnp.where(valid, delta, states[None, :] + offset)
    return k_e.astype(jnp.int32), a_e.astype(jnp.int32), b_e.astype(jnp.int32), delta.astype(jnp.int32)


@jax.jit
def build_decode_tables(weights: jnp.ndarray):
    """weights: (B, 360) int32 -> (v_packed (B,384), v_base (B,384),
    u_packed (B,1024)), all int32."""
    wl = weights[:, :C.L_TOP]
    wm = weights[:, C.L_TOP:C.M_TOP]
    wd = weights[:, C.M_TOP:C.D_TOP]
    wu = weights[:, C.D_TOP:C.U_TOP]

    lk, lbits, lbase, ldelta = _build_block(
        wl, C.L_STATES, 0,
        jnp.asarray(C.L_EXTRA_BITS), jnp.asarray(C.L_BASE_VALUE), 0, False)
    mk, mbits, mbase, mdelta = _build_block(
        wm, C.M_STATES, C.L_STATES,
        jnp.asarray(C.M_EXTRA_BITS), jnp.asarray(C.M_BASE_VALUE), 0, False)
    dk, dbits, dbase, ddelta = _build_block(
        wd, C.D_STATES, C.L_STATES + C.M_STATES,
        jnp.asarray(C.D_EXTRA_BITS), jnp.asarray(C.D_BASE_VALUE), 0, False)
    uk, usym, _, udelta = _build_block(
        wu, C.U_STATES, 0,
        jnp.arange(C.U_SYMBOLS, dtype=jnp.int32),
        jnp.zeros(C.U_SYMBOLS, dtype=jnp.int32), 0, True)

    v_k = jnp.concatenate([lk, mk, dk], axis=1)
    v_bits = jnp.concatenate([lbits, mbits, dbits], axis=1)
    v_base = jnp.concatenate([lbase, mbase, dbase], axis=1)
    v_delta = jnp.concatenate([ldelta, mdelta, ddelta], axis=1)
    # Packed single-int32 entries: one load per table lookup, in the XLA
    # scans (ops/fse_decode.py) and the GPU kernels (ops/tans_gpu.py).
    #
    # V entries additionally carry the value base in bits 17..31: L/M bases
    # fit directly (<= 312); the D lane stores the D symbol index instead
    # (6 bits), whose base the GPU kernel computes in closed form (the XLA
    # scan reads v_base).
    d_sym_of_state = jnp.argmin(
        jnp.where(jnp.asarray(C.D_BASE_VALUE)[None, None, :]
                  == dbase[:, :, None], 
                  jax.lax.broadcasted_iota(jnp.int32, (1, 1, C.D_SYMBOLS), 2),
                  jnp.int32(C.D_SYMBOLS)), axis=2).astype(jnp.int32)
    lm_base = jnp.concatenate([lbase, mbase], axis=1)
    v_hi = jnp.concatenate([lm_base, d_sym_of_state], axis=1)
    v_packed = v_k | (v_bits << 4) | (v_delta << 8) | (v_hi << 17)
    u_packed = uk | (usym << 4) | (udelta << 12)
    return v_packed, v_base, u_packed
