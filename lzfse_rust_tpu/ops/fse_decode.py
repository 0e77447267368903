"""Batched tANS stream decode in plain XLA — the CPU path for FSE payloads
and the reference for the GPU kernels (ops/tans_gpu.py).

The format's interleaved-state design (4 literal states, 3 L/M/D states
sharing one backwards bitstream: src/fse/literals.rs:49-91, lmds.rs:27-60) is
its built-in parallelism affordance; this module adds the batch dimension:
every block in flight decodes simultaneously, one fused `lax.scan` step per
symbol group, with per-block decode tables gathered from device arrays.

Each table entry is ONE packed int32, so a lookup is a single gather, and
the scan carry is a flat tuple of (B,) vectors, which keeps the loop body
one fusion. Packed entry layouts:

  U entry:  k | sym << 4 | delta << 12              (k<=10, sym<256, delta<1024)
  V entry:  k | v_bits << 4 | delta << 8 | hi << 17 (delta < 384; hi = value
            base for L/M lanes, D symbol index for the D lane; the separate
            v_base array remains the straightforward source in this portable
            path)

Bitstream model: absolute bit position over the payload (see spec/bits.py).
Payloads are pre-expanded to overlapping 4-byte little-endian windows so each
pull is a single gather:  bits = (W[pos >> 3] >> (pos & 7)) & mask(k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def bytes_to_windows(payload: jnp.ndarray) -> jnp.ndarray:
    """(B, P) uint8 -> (B, P-3) uint32 overlapping LE 4-byte windows."""
    p = payload.astype(jnp.uint32)
    return (p[:, :-3] | (p[:, 1:-2] << 8) | (p[:, 2:-1] << 16)
            | (p[:, 3:] << 24))


def _pull(windows, pos, n):
    """Pull `n` bits ending at bit position `pos` (per batch row)."""
    new_pos = pos - n
    safe = jnp.maximum(new_pos, 0)
    w = jnp.take_along_axis(windows, (safe >> 3)[:, None], axis=1)[:, 0]
    bits = ((w >> (safe & 7).astype(jnp.uint32))
            & ((jnp.uint32(1) << n.astype(jnp.uint32)) - 1)).astype(jnp.int32)
    return jnp.where(new_pos < 0, 0, bits), new_pos


@functools.partial(jax.jit, static_argnames=("n_steps",))
def decode_literals_batch(u_packed: jnp.ndarray, windows: jnp.ndarray,
                          init_states: jnp.ndarray, init_pos: jnp.ndarray,
                          num: jnp.ndarray, n_steps: int):
    """Decode up to n_steps*4 literals per block.

    u_packed: (B, 1024) int32 packed entries; windows: (B, W) uint32;
    init_states: (B, 4); init_pos: (B,); num: (B,) literal counts (multiples
    of 4). Returns (literals (B, n_steps*4) uint8, final_states (B, 4),
    final_pos (B,)).
    """
    B = u_packed.shape[0]

    def step(carry, i):
        s0, s1, s2, s3, pos = carry
        active = (i * 4) < num
        new_states = []
        syms = []
        for s in (s0, s1, s2, s3):
            e = jnp.take_along_axis(u_packed, s[:, None], axis=1)[:, 0]
            k = e & 15
            sym = (e >> 4) & 255
            delta = e >> 12
            bits, new_pos = _pull(windows, pos, k)
            pos = jnp.where(active, new_pos, pos)
            new_states.append(jnp.where(active, bits + delta, s))
            syms.append(sym)
        return (tuple(new_states) + (pos,),
                jnp.stack(syms, axis=1).astype(jnp.uint8))

    init = tuple(init_states[:, i] for i in range(4)) + (init_pos,)
    (s0, s1, s2, s3, pos), lits = jax.lax.scan(
        step, init, jnp.arange(n_steps, dtype=jnp.int32))
    literals = jnp.transpose(lits, (1, 0, 2)).reshape(B, -1)
    return literals, jnp.stack([s0, s1, s2, s3], axis=1), pos


@functools.partial(jax.jit, static_argnames=("n_steps",))
def decode_lmds_batch(v_packed: jnp.ndarray, v_base: jnp.ndarray,
                      windows: jnp.ndarray, init_states: jnp.ndarray,
                      init_pos: jnp.ndarray, num: jnp.ndarray, n_steps: int):
    """Decode up to n_steps LMD triples per block.

    v_packed/v_base: (B, 384) int32; init_states: (B, 3) absolute
    compound-table states (L at +0, M at +64, D at +128). Returns
    (lmds (B, n_steps, 3) int32, final_states (B, 3), final_pos (B,)).
    Inactive steps emit (0, 0, 0) rows — no-ops for LZ reconstruction.
    """
    def one(s, pos, active):
        e = jnp.take_along_axis(v_packed, s[:, None], axis=1)[:, 0]
        base = jnp.take_along_axis(v_base, s[:, None], axis=1)[:, 0]
        k = e & 15
        nb = (e >> 4) & 15
        delta = (e >> 8) & 0x1FF  # bits 17+ carry the packed value base
        sbits, pos1 = _pull(windows, pos, k)
        vbits, pos2 = _pull(windows, pos1, nb)
        s_new = jnp.where(active, sbits + delta, s)
        pos = jnp.where(active, pos2, pos)
        return s_new, pos, jnp.where(active, base + vbits, 0)

    def step(carry, i):
        sl, sm, sd, pos = carry
        active = i < num
        sl, pos, l = one(sl, pos, active)
        sm, pos, m = one(sm, pos, active)
        sd, pos, d = one(sd, pos, active)
        return (sl, sm, sd, pos), jnp.stack([l, m, d], axis=1)

    init = tuple(init_states[:, i] for i in range(3)) + (init_pos,)
    (sl, sm, sd, pos), lmds = jax.lax.scan(
        step, init, jnp.arange(n_steps, dtype=jnp.int32))
    return (jnp.transpose(lmds, (1, 0, 2)), jnp.stack([sl, sm, sd], axis=1),
            pos)
