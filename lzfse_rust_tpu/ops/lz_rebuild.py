"""Batched LZ77 output reconstruction via pointer doubling.

The decode sink's match copies are byte-serial in the reference
(src/lz/object.rs:27-74 with register-expansion tricks for small distances).
On a device the same semantics become a parallel fixed point: every output byte's
value is ultimately some literal byte, reached through a chain of
"copy from distance d back" links. Since each link strictly decreases the
position, the chain is acyclic and pointer doubling (composing the parent map
with itself) resolves every byte in ceil(log2(n)) gather rounds — the
log-step expansion SURVEY.md §7 calls for.

This operates on whole *containers*, not single blocks: the reference decode
sink is continuous across blocks (decoder.rs:79-99), so matches legally
reference bytes produced by earlier blocks of any type. All blocks of a
container are therefore flattened into one (l, m, d) row stream sharing one
literal pool before reconstruction:
  - FSE blocks contribute their decoded LMD rows (distances already
    zero-substituted per block),
  - LZVN blocks contribute their opcode stream as rows,
  - Raw blocks contribute a single all-literal row.

Steps (batched over containers):
  1. prefix sums of (l, m) give each row's literal/match spans
  2. searchsorted maps output positions -> owning row
  3. literal positions are roots; match positions point at pos - d
  4. pointer doubling; gather literals at the resolved roots
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def substitute_distances(d_packed: jnp.ndarray) -> jnp.ndarray:
    """Resolve zeroed repeat distances: d_eff[i] = last nonzero d at or before
    i (0 if none). Vectorized equivalent of MatchDistanceUnpack::substitute
    (src/lmd/lmd_type.rs:153-160). Applied per block, whose first distance is
    always explicit (fse/buffer.rs resets match_distance per block)."""
    idx = jnp.arange(d_packed.shape[-1], dtype=jnp.int32)
    marked = jnp.where(d_packed != 0, idx[None, :], -1)
    last_nz = jax.lax.cummax(marked, axis=1)
    safe = jnp.maximum(last_nz, 0)
    d_eff = jnp.take_along_axis(d_packed, safe, axis=1)
    return jnp.where(last_nz < 0, 0, d_eff)


@functools.partial(jax.jit, static_argnames=("n_out",))
def lz_rebuild_batch(literals: jnp.ndarray, rows: jnp.ndarray,
                     n_raw: jnp.ndarray, n_out: int):
    """Rebuild container outputs from flattened row streams.

    literals: (B, L) uint8 literal pools; rows: (B, R, 3) int32
    (literal_len, match_len, d_effective) with padding rows == (0,0,0);
    n_raw: (B,) true output sizes; n_out: padded output size (static,
    >= max(n_raw)). Returns (out (B, n_out) uint8, ok (B,) bool); ok captures
    the reference's validity conditions (fse_core.rs:116-140, lz/writer.rs
    write_match distance bounds).
    """
    B, R, _ = rows.shape
    l = rows[:, :, 0]
    m = rows[:, :, 1]
    d_eff = rows[:, :, 2]

    lit_end = jnp.cumsum(l, axis=1)                 # literals consumed incl. row
    span_end = jnp.cumsum(l + m, axis=1)            # output produced incl. row
    span_start = span_end - (l + m)
    match_start = span_end - m

    total = span_end[:, -1]
    has_match = m > 0
    d_ok = jnp.where(has_match,
                     (d_eff > 0) & (d_eff <= match_start), True).all(axis=1)
    lit_ok = lit_end[:, -1] <= literals.shape[1]
    ok = d_ok & lit_ok & (total == n_raw)

    out_pos = jnp.arange(n_out, dtype=jnp.int32)
    # Owning row of each output position: first row with span_end > pos.
    row = jax.vmap(
        lambda se: jnp.searchsorted(se, out_pos, side="right"))(span_end)
    row = jnp.minimum(row, R - 1).astype(jnp.int32)

    r_span_start = jnp.take_along_axis(span_start, row, axis=1)
    r_match_start = jnp.take_along_axis(match_start, row, axis=1)
    r_lit_end = jnp.take_along_axis(lit_end, row, axis=1)
    r_l = jnp.take_along_axis(l, row, axis=1)
    r_d = jnp.take_along_axis(d_eff, row, axis=1)

    pos = out_pos[None, :]
    is_lit = pos < r_match_start
    lit_idx = r_lit_end - r_l + (pos - r_span_start)
    lit_idx = jnp.clip(lit_idx, 0, literals.shape[1] - 1)
    parent = jnp.where(is_lit, pos, pos - jnp.maximum(r_d, 1))
    parent = jnp.clip(parent, 0, n_out - 1)

    # Pointer doubling: compose the parent map with itself log2(n_out) times;
    # literal roots are fixed points, so the composition saturates.
    root = parent
    for _ in range(max(int(n_out - 1).bit_length(), 1)):
        root = jnp.take_along_axis(root, root, axis=1)

    root_lit = jnp.take_along_axis(lit_idx, root, axis=1)
    out = jnp.take_along_axis(literals, root_lit, axis=1)
    out = jnp.where(pos < n_raw[:, None], out, 0)
    return out, ok
