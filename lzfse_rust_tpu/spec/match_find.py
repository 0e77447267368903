"""Vectorized LZ77 match finding — the spec-layer match pipeline.

The reference match finder (src/encode/frontend_bytes.rs:160-268 +
src/encode/history.rs) is a per-byte sequential loop over a 4-way hash-bucket
FIFO. Its key property, which this module exploits and the device kernels rely
on: *history contents are match-decision independent*. Every position < i has
been pushed into its bucket exactly once, in order, by the time position i is
probed (the hot loop pushes the probed position, and sync_history pushes all
skipped positions: frontend_bytes.rs:185-199, 336-344). Hence the candidate
set of position i is exactly "the last HASH_WIDTH positions j < i hashing to
the same bucket" — a pure function of the input computable in parallel for
all positions at once.

Pipeline (all numpy-vectorized):
  1. u32 values + Knuth multiplicative hash -> bucket per position
  2. per-bucket windowed candidate gather (previous 4 same-bucket positions)
  3. match-unit filter (exact u32 equality for FSE, low-3-byte for LZVN)
  4. forward LCP extension (8-byte XOR steps, like match_fast.rs:22-49)
  5. candidate arbitration: first-in-recency-order strict-max
     (frontend_bytes.rs:226-229 uses `>` so earlier FIFO entries win ties)
  6. backward LCP extension capped by match_index (match_fast.rs:61-89);
     the emission-time literal cap is applied later by the selection scan.

The output is, for every position with a candidate match, the tuple
(pos, match_pos, fwd_len, back_ext_max). The cheap order-dependent greedy/lazy
selection scan (match_object.rs:12-33) consumes this stream sequentially.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..base import constants as C


@dataclass
class MatchStream:
    """Per-candidate-position match data, sorted by position."""

    pos: np.ndarray        # i64 position of the probe (Match.idx before back-ext)
    match_pos: np.ndarray  # i64 position of the match source
    fwd_len: np.ndarray    # i64 forward match length (includes the match unit)
    back_max: np.ndarray   # i64 backward extension cap'd by match_pos only


def u32_values(src: np.ndarray) -> np.ndarray:
    """Little-endian u32 at every position 0..n-4 (vectorized get_u32)."""
    n = len(src)
    if n < 4:
        return np.zeros(0, dtype=np.uint32)
    s = src.astype(np.uint32)
    return (s[:n - 3] | (s[1:n - 2] << 8) | (s[2:n - 1] << 16) | (s[3:n] << 24))


def _buckets(vals: np.ndarray, vn: bool) -> np.ndarray:
    """Hash values into 2^14 buckets (history.rs:221-224, object.rs hash_u)."""
    if vn:
        vals = vals & np.uint32(0x00FFFFFF)
    h = (vals * np.uint32(C.HASH_MUL)) & np.uint32(0xFFFFFFFF)
    return (h >> np.uint32(32 - C.HASH_BITS)).astype(np.int64)


def _candidates(buckets: np.ndarray, vals: np.ndarray, vn: bool,
                max_d: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each position, its previous HASH_WIDTH same-bucket positions that
    pass the distance and match-unit filters.

    Returns (pos, cand, recency) flat pairs sorted by (pos, recency): for a
    given pos the candidates appear most-recent first, mirroring History FIFO
    order. Filters are applied per recency level before concatenation to keep
    the working set small.
    """
    n = len(buckets)
    order = np.argsort(buckets, kind="stable")  # groups buckets, pos asc inside
    sorted_buckets = buckets[order]
    pos_list, cand_list = [], []
    for back in range(1, C.HASH_WIDTH + 1):
        # candidate `back` steps earlier in the same bucket group
        valid = np.zeros(n, dtype=bool)
        valid[back:] = sorted_buckets[back:] == sorted_buckets[:-back]
        p = order[valid]
        q = order[np.roll(valid, -back)]
        keep = (p - q) <= max_d
        if vn:
            keep &= ((vals[p] ^ vals[q]) & np.uint32(0x00FFFFFF)) == 0
        else:
            keep &= vals[p] == vals[q]
        pos_list.append(p[keep])
        cand_list.append(q[keep])
    pos = np.concatenate(pos_list)
    cand = np.concatenate(cand_list)
    recency = np.concatenate(
        [np.full(len(p), r, dtype=np.int64) for r, p in enumerate(pos_list)])
    # Sort by (pos, recency) so each position's candidates are recency-ordered.
    key = np.lexsort((recency, pos))
    return pos[key], cand[key], recency[key]


_MAX_LCP_WINDOW = 4096


def _chain_runs(a: np.ndarray, b: np.ndarray):
    """Run decomposition for the LCP chain rule. Rows at consecutive
    positions with the SAME distance d = a - b satisfy
        E(p) = E(p+1) + 1      (forward run length)
        B(p) = B(p-1) + 1      (backward run length)
    whenever the earlier row has >= 1 byte of forward equality — true for
    every caller (rows are match candidates with lcp >= 3, or re-extension
    rows with start >= 4). So only one REPRESENTATIVE per run needs a real
    byte comparison; the rest back-fill linearly. This turns the
    O(rows x matchlen) blow-up on periodic data (html_x_4: 307KB-long
    matches at every position of every repeat) into O(run content).

    Returns (order, run_id_sorted, run_tail_sorted_idx, run_head_sorted_idx)
    over the lexsort-by-(d, a) ordering."""
    d = a.astype(np.int64) - b
    order = np.lexsort((a, d))
    ao = a[order]
    do = d[order]
    n = len(a)
    brk = np.empty(n, bool)
    if n:
        brk[0] = True
        brk[1:] = (do[1:] != do[:-1]) | (ao[1:] != ao[:-1] + 1)
    rid = np.cumsum(brk) - 1
    heads = np.flatnonzero(brk)
    tails = np.empty(len(heads), np.int64)
    tails[:-1] = heads[1:] - 1
    if len(heads):
        tails[-1] = n - 1
    return order, rid, tails, heads


def _lcp_forward(src: np.ndarray, a: np.ndarray, b: np.ndarray,
                 start: np.ndarray, maxlen: np.ndarray) -> np.ndarray:
    """Vectorized LCP of src[a+start:] vs src[b+start:], clamped to maxlen.

    Chain rule: real comparisons run only on run TAILS (_chain_runs);
    every other row of a run is E(tail) + (tail_pos - pos), clamped.
    Exactness requires maxlen(p) - (N - p) constant along a run — all
    callers pass block/window-end caps of that form. The precondition
    (>= 1 leading equal byte per row) holds for every caller.
    """
    if len(a) > 64:
        order, rid, tails, _ = _chain_runs(a, b)
        ridx = order[tails]
        e_tail = _lcp_core_fwd(src, a[ridx], b[ridx], start[ridx],
                               maxlen[ridx])
        out = np.empty(len(a), np.int64)
        out[order] = e_tail[rid] + (a[order[tails]][rid] - a[order])
        return np.minimum(out, maxlen)
    return _lcp_core_fwd(src, a, b, start, maxlen)


def _lcp_core_fwd(src: np.ndarray, a: np.ndarray, b: np.ndarray,
                  start: np.ndarray, maxlen: np.ndarray) -> np.ndarray:
    """Geometric-window LCP compare (fast_match_inc, match_fast.rs:22-49):
    8, 16, ... byte windows, so multi-KB matches cost O(log) vectorized
    rounds; the first unequal window locates the mismatch via argmax."""
    out = start.astype(np.int64).copy()
    active = np.arange(len(a))
    pad = np.concatenate([src, np.zeros(_MAX_LCP_WINDOW, dtype=np.uint8)])
    views = {}
    step = 8
    while len(active):
        views.setdefault(
            step, np.lib.stride_tricks.sliding_window_view(pad, step))
        w = views[step]
        ai = a[active] + out[active]
        bi = b[active] + out[active]
        neq = w[ai] != w[bi]
        any_neq = neq.any(axis=1)
        first = np.where(any_neq, neq.argmax(axis=1), step)
        out[active] += first
        done = any_neq | (out[active] >= maxlen[active])
        active = active[~done]
        step = min(step * 2, _MAX_LCP_WINDOW)
    return np.minimum(out, maxlen)


def _lcp_backward(src: np.ndarray, a: np.ndarray, b: np.ndarray,
                  maxlen: np.ndarray) -> np.ndarray:
    """Vectorized backward LCP of src[..a] vs src[..b], clamped to maxlen.

    Chain rule: real comparisons run only on run HEADS (see _lcp_forward /
    _chain_runs); other rows are B(head) + (pos - head_pos), clamped.
    Exactness requires maxlen(p) - p constant along a run — all callers
    pass min(pos, cand)-form caps."""
    if len(a) > 64:
        order, rid, _, heads = _chain_runs(a, b)
        ridx = order[heads]
        b_head = _lcp_core_bwd(src, a[ridx], b[ridx], maxlen[ridx])
        out = np.empty(len(a), np.int64)
        out[order] = b_head[rid] + (a[order] - a[order[heads]][rid])
        return np.minimum(out, maxlen)
    return _lcp_core_bwd(src, a, b, maxlen)


def _lcp_core_bwd(src: np.ndarray, a: np.ndarray, b: np.ndarray,
                  maxlen: np.ndarray) -> np.ndarray:
    """Reversed geometric-window LCP compare (fast_match_dec,
    match_fast.rs:61-89)."""
    out = np.zeros(len(a), dtype=np.int64)
    active = np.arange(len(a))
    pad = np.concatenate([np.zeros(_MAX_LCP_WINDOW, dtype=np.uint8), src])
    rev = pad[::-1].copy()
    n_pad = len(pad)
    views = {}
    step = 8
    while len(active):
        views.setdefault(
            step, np.lib.stride_tricks.sliding_window_view(rev, step))
        w = views[step]
        # bytes src[x-1], src[x-2], ... == rev[n_pad-x-... ]: window starting
        # at rev index n_pad - x reads pad[x-1], pad[x-2], ...
        ai = n_pad - (_MAX_LCP_WINDOW + a[active] - out[active])
        bi = n_pad - (_MAX_LCP_WINDOW + b[active] - out[active])
        neq = w[ai] != w[bi]
        any_neq = neq.any(axis=1)
        first = np.where(any_neq, neq.argmax(axis=1), step)
        out[active] += first
        done = any_neq | (out[active] >= maxlen[active])
        active = active[~done]
        step = min(step * 2, _MAX_LCP_WINDOW)
    return np.minimum(out, maxlen)


def find_matches(src_bytes: bytes, vn: bool) -> MatchStream:
    """Run the full vectorized match pipeline over one block of input.

    `vn` selects the LZVN match unit (3 bytes, distance cap 0xFFFF) versus the
    FSE unit (4 bytes, cap 262139).
    """
    src = np.frombuffer(src_bytes, dtype=np.uint8)
    n = len(src)
    empty = np.zeros(0, dtype=np.int64)
    if n < 4:
        return MatchStream(empty, empty, empty, empty)
    vals = u32_values(src)
    # The hot loop probes index while index < len-3, i.e. positions 0..=n-4;
    # all of them are also pushed (frontend_bytes.rs:171-207).
    if len(vals) <= 1:
        return MatchStream(empty, empty, empty, empty)
    max_d = C.VN_MAX_D_VALUE if vn else C.MAX_D_VALUE
    buckets = _buckets(vals, vn)
    pos, cand, recency = _candidates(buckets, vals, vn, max_d)
    if len(pos) == 0:
        return MatchStream(empty, empty, empty, empty)
    # Match unit: exact u32 equality -> unit 4 (+ extension); LZVN also
    # accepts low-3-byte-only equality -> fixed length 3 (vn/object.rs:50-59).
    eq4 = vals[pos] == vals[cand]
    # Forward extension from length 4 where the full unit matched
    # (frontend_bytes.rs:247-258: only len==4 extends).
    maxlen = (n - pos).astype(np.int64)
    fwd = np.full(len(pos), 3, dtype=np.int64)
    if eq4.any():
        idx4 = np.flatnonzero(eq4)
        fwd[idx4] = _lcp_forward(src, pos[idx4], cand[idx4],
                                 np.full(len(idx4), 4, np.int64), maxlen[idx4])
    # Arbitration: first candidate (in recency order) with strictly maximal
    # length wins (`>` comparison, frontend_bytes.rs:226-229). Encode as a
    # score where length dominates and lower recency breaks ties.
    score = fwd * 8 - recency  # fwd >= 3, recency < 8 -> exact `>` order
    group_change = np.diff(pos, prepend=pos[0]) != 0
    group_id = np.cumsum(group_change)
    n_groups = int(group_id[-1]) + 1
    best_score = np.full(n_groups, -1, dtype=np.int64)
    np.maximum.at(best_score, group_id, score)
    is_best = score == best_score[group_id]
    first_idx = np.full(n_groups, len(pos), dtype=np.int64)
    np.minimum.at(first_idx, group_id[is_best], np.flatnonzero(is_best))
    sel = first_idx[first_idx < len(pos)]
    pos_b, cand_b, fwd_b = pos[sel], cand[sel], fwd[sel]
    back = _lcp_backward(src, pos_b, cand_b, cand_b.astype(np.int64))
    return MatchStream(pos_b.astype(np.int64), cand_b.astype(np.int64),
                       fwd_b, back)
