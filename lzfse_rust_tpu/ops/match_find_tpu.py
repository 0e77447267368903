"""Device-side LZ77 match finding — the device encoder front end.

Exploits the decision-independence of the reference's history table (see
spec/match_find.py): the candidate set of position i is exactly the last
HASH_WIDTH positions j < i hashing to i's bucket, a pure function of the
input. On device:

  1. u32 values + Knuth hash -> bucket per position (elementwise)
  2. stable argsort by bucket; a position's candidates are its 1..4
     predecessors in sorted order with equal bucket (shifted compares —
     no scatter; results stay in sorted order and the host reorders)
  3. forward/backward LCP via 64-byte *row* gathers with compare + argmax;
     rare >64-byte runs extend on the host
  4. FIFO-order strict-max arbitration (frontend_bytes.rs:226-229)

Output: per probed position its 4 recency-ordered candidates with
first-window LCPs, in bucket-sorted order. The host extends the rare
window-saturated rows exactly, arbitrates (FIFO strict-max), computes the
winners' backward extension, and runs the cheap sequential greedy/lazy
selection (spec/frontend.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..base import constants as C

WINDOW = 64  # bytes compared per device LCP; longer runs extend on host.
             # In-device extension loops were tried and rejected: the
             # static-shape gathers re-touch all N rows for a handful of
             # active ones.


def _windows_fwd(src_pad: jnp.ndarray) -> jnp.ndarray:
    """(N,) uint8 -> (N, WINDOW) forward byte windows (materialized shifts).

    The optimization barrier forces materialization: otherwise XLA fuses the
    roll-stack into every row gather, scalarizing them.

    Built as a flat concat + reshape + transpose. jnp.stack (any axis)
    expands each rolled column with a singleton dim, which layout
    assignment may pad in the HLO temps; concatenating the (N,) columns
    along the existing axis never creates one, so the temps stay at true
    size, and one transpose then lays out the (N, WINDOW) row-gather
    operand.
    """
    N = src_pad.shape[-1]
    cols = [jnp.roll(src_pad, -k) for k in range(WINDOW)]
    wf_t = jnp.concatenate(cols, axis=-1).reshape(
        src_pad.shape[:-1] + (WINDOW, N))
    return jax.lax.optimization_barrier(jnp.swapaxes(wf_t, -1, -2))


def _first_mismatch(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    neq = a != b
    any_neq = neq.any(axis=1)
    return jnp.where(any_neq, jnp.argmax(neq, axis=1).astype(jnp.int32),
                     jnp.int32(WINDOW))


@functools.partial(jax.jit, static_argnames=("vn",))
def find_matches_device(src_pad: jnp.ndarray, n_real: jnp.ndarray, vn: bool):
    """Candidate + first-window-LCP pipeline over one padded input window.

    src_pad: (N,) uint8, zero-padded past n_real (N static, bucketable).
    Returns (pos (N,), cands (HASH_WIDTH, N), lcps (HASH_WIDTH, N)) in
    bucket-sorted order: cands[r-1] is the r-th most recent same-bucket
    predecessor (or -1), lcps capped at min(WINDOW, block end). The host
    arbitrates (extending the rare WINDOW-saturated rows exactly first) and
    computes backward extension for the winners.
    """
    N = src_pad.shape[0]
    s = src_pad.astype(jnp.uint32)
    vals = (s | (jnp.roll(s, -1) << 8) | (jnp.roll(s, -2) << 16)
            | (jnp.roll(s, -3) << 24))
    hv = vals & jnp.uint32(0x00FFFFFF) if vn else vals
    bucket = ((hv * jnp.uint32(C.HASH_MUL))
              >> jnp.uint32(32 - C.HASH_BITS)).astype(jnp.int32)
    # probed positions: 0 .. n_real-4 (frontend_bytes.rs:171-183)
    idx = jnp.arange(N, dtype=jnp.int32)
    probed = idx <= (n_real - 4)
    # push un-probed positions into a reserved bucket so they never match
    bucket = jnp.where(probed, bucket, jnp.int32(1 << C.HASH_BITS))

    order = jnp.argsort(bucket, stable=True).astype(jnp.int32)
    b_sorted = jnp.take(bucket, order)
    pos = order  # position of sorted slot

    max_d = C.VN_MAX_D_VALUE if vn else C.MAX_D_VALUE
    wf = _windows_fwd(src_pad)
    cap = n_real - pos  # LCP bound: block end (frontend_bytes.rs:253 `max`)

    a = jnp.take(wf, pos, axis=0)
    cands = []
    lcps = []
    for r in range(1, C.HASH_WIDTH + 1):
        cand = jnp.roll(order, r)
        same = jnp.roll(b_sorted, r) == b_sorted
        same = same & (jnp.arange(N) >= r)
        ok = same & ((pos - cand) <= max_d) & (cand < pos)
        safe_cand = jnp.where(ok, cand, 0)
        b = jnp.take(wf, safe_cand, axis=0)
        lcp = jnp.clip(_first_mismatch(a, b), 0, cap)
        lcp = jnp.where(ok, lcp, 0)
        cands.append(jnp.where(ok, cand, -1))
        lcps.append(lcp)
    return pos, jnp.stack(cands), jnp.stack(lcps)


def _grouped_core(src_pad, n_real, order, ok):
    """Candidate + first-window-LCP pipeline with the bucket grouping
    precomputed on host (native tl_match_group's stable counting sort ==
    the argsort this replaces; see runtime/native.match_group). No device
    sort anywhere: a device argsort over every window position was the
    device frontend's bottleneck. order: (N,) int32 grouped
    positions; ok: (N,) uint8 masks, bit r-1 set when order[slot-r] is a
    valid candidate (same bucket, distance <= max_d). Output contract as
    find_matches_device (unprobed positions simply carry no candidates)."""
    pos = order
    cap = n_real - pos
    wf = _windows_fwd(src_pad)
    # ONE row gather for the whole window: in grouped order, candidate r
    # of slot s is slot s-r, so every candidate's forward window is just
    # roll(a, r) along the slot axis — an aligned shift instead of four
    # extra 1M-row gathers
    a = jnp.take(wf, pos, axis=0)
    cands = []
    lcps = []
    for r in range(1, C.HASH_WIDTH + 1):
        cand = jnp.roll(order, r)
        okr = ((ok >> (r - 1)) & 1) != 0
        b = jnp.roll(a, r, axis=0)
        lcp = jnp.clip(_first_mismatch(a, b), 0, cap)
        lcp = jnp.where(okr, lcp, 0)
        cands.append(jnp.where(okr, cand, -1))
        lcps.append(lcp)
    return pos, jnp.stack(cands), jnp.stack(lcps)


@functools.partial(jax.jit, static_argnames=("vn",))
def find_matches_grouped(src_pad: jnp.ndarray, n_real: jnp.ndarray,
                         order: jnp.ndarray, ok: jnp.ndarray, vn: bool):
    """Sort-free single-window variant of find_matches_device (vn selects
    the 3-byte match-unit arbitration downstream; the masks already encode
    the vn hash/distance rules)."""
    del vn  # semantics ride in the host-computed masks; kept for symmetry
    return _grouped_core(src_pad, n_real, order, ok)


def _grouped_compact_one(src_pad, n_real, lo, hi, order, ok, vn: bool):
    """Sort-free arbitration for one window: same FIFO strict-max decision
    as _compact_one but NO device partition sort and NO narrow-minor-dim
    (N, 3)/(N, 9) row matrices. The kernel returns flat (N,) vectors in
    grouped-slot space: the host already holds `order` (it built it), so
    a matched slot's (pos, cand, len) come from (order, best_cand,
    best_len) directly, and only the rare sat slots need a device gather
    of their candidate columns (take_sat_cols)."""
    pos, cands, lcps = _grouped_core(src_pad, n_real, order, ok)
    best_len = jnp.zeros_like(pos)
    best_cand = jnp.zeros_like(pos)
    sat = jnp.zeros(pos.shape, bool)
    for r in range(cands.shape[0]):
        cand = cands[r]
        lcp = lcps[r]
        okc = cand >= 0
        if vn:
            mlen = jnp.where(lcp >= 4, lcp, jnp.where(lcp == 3, 3, 0))
        else:
            mlen = jnp.where(lcp >= 4, lcp, 0)
        mlen = jnp.where(okc, mlen, 0)
        sat = sat | (okc & ((lcp == WINDOW) | (pos + lcp >= n_real)))
        take = mlen > best_len
        best_len = jnp.where(take, mlen, best_len)
        best_cand = jnp.where(take, cand, best_cand)
    payload = (pos >= lo) & (pos < hi)
    sat = payload & sat
    matched = payload & ((best_len > 0) | sat)
    key = jnp.where(sat, 0, jnp.where(matched, 1, 2)).astype(jnp.uint8)
    return key, best_cand, best_len, cands, lcps


@functools.partial(jax.jit, static_argnames=("vn",))
def find_matches_grouped_compact(src_pads, n_reals, los, his, orders, oks,
                                 vn: bool):
    """Batched sort-free window match finding (see _grouped_compact_one).
    Returns (keys (B,N) uint8, best_cand (B,N), best_len (B,N),
    cands (B,HASH_WIDTH,N), lcps (B,HASH_WIDTH,N)); the candidate arrays
    stay device-resident for the host-directed take_sat_cols gather."""
    return jax.vmap(
        lambda s, n, lo, hi, o, k: _grouped_compact_one(s, n, lo, hi, o, k,
                                                        vn),
        in_axes=(0, 0, 0, 0, 0, 0))(src_pads, n_reals, los, his, orders,
                                     oks)


@jax.jit
def take_sat_cols(cands, lcps, idx):
    """Host-directed download of the rare window-saturated slots' candidate
    columns. cands/lcps: (B, HASH_WIDTH, N); idx: (B, S) int32 (slot
    indices, zero-padded). S is small — sat rows are the exception set
    re-extended exactly on host."""
    take = lambda a, i: jax.vmap(
        lambda a2, i1: jnp.take(a2, i1, axis=1))(a, i)
    return take(cands, idx), take(lcps, idx)


@functools.partial(jax.jit, static_argnames=("vn",))
def find_matches_batch(src_pads: jnp.ndarray, n_reals: jnp.ndarray,
                       vn: bool):
    """Batched window match finding: one dispatch for every same-size
    window in an encode_many call (amortizes per-dispatch latency).
    src_pads: (B, N)
    uint8; n_reals: (B,) int32. Per-window outputs as find_matches_device,
    batch-leading."""
    return jax.vmap(
        lambda s, n: find_matches_device.__wrapped__(s, n, vn),
        in_axes=(0, 0))(src_pads, n_reals)


def _compact_one(src_pad, n_real, lo, hi, vn: bool):
    """Device-side FIFO strict-max arbitration + compaction for one window.

    Rows whose arbitration is certain on-device (no candidate saturated at
    the compare WINDOW or truncated by the chunk end) finish here; rows
    needing exact host re-extension sort to the front, then other matched
    rows, then everything else — so the host downloads counts first and
    then only count-bounded slices (the 9-words-per-position full download
    dominated encode wall time). lo/hi bound the payload region (context
    and overhang probes are discarded on-device)."""
    pos, cands, lcps = find_matches_device.__wrapped__(src_pad, n_real, vn)
    best_len = jnp.zeros_like(pos)
    best_cand = jnp.zeros_like(pos)
    sat = jnp.zeros(pos.shape, bool)
    for r in range(cands.shape[0]):
        cand = cands[r]
        lcp = lcps[r]
        okc = cand >= 0
        if vn:
            mlen = jnp.where(lcp >= 4, lcp, jnp.where(lcp == 3, 3, 0))
        else:
            mlen = jnp.where(lcp >= 4, lcp, 0)
        mlen = jnp.where(okc, mlen, 0)
        sat = sat | (okc & ((lcp == WINDOW) | (pos + lcp >= n_real)))
        take = mlen > best_len
        best_len = jnp.where(take, mlen, best_len)
        best_cand = jnp.where(take, cand, best_cand)
    payload = (pos >= lo) & (pos < hi)
    sat = payload & sat
    matched = payload & ((best_len > 0) | sat)
    key = jnp.where(sat, 0, jnp.where(matched, 1, 2)).astype(jnp.int32)
    order2 = jnp.argsort(key, stable=True).astype(jnp.int32)
    counts = jnp.stack([jnp.sum(sat.astype(jnp.int32)),
                        jnp.sum(matched.astype(jnp.int32))])
    return (counts, jnp.take(pos, order2), jnp.take(best_cand, order2),
            jnp.take(best_len, order2), jnp.take(cands, order2, axis=1),
            jnp.take(lcps, order2, axis=1))


@functools.partial(jax.jit, static_argnames=("vn",))
def find_matches_compact(src_pads: jnp.ndarray, n_reals: jnp.ndarray,
                         los: jnp.ndarray, his: jnp.ndarray, vn: bool):
    """Batched compact window match finding (see _compact_one). Returns
    (counts (B,2) [n_sat, n_matched], pos (B,N), best_cand (B,N),
    best_len (B,N), cands (B,HASH_WIDTH,N), lcps (B,HASH_WIDTH,N)) —
    each window's rows ordered sat-first then matched; callers slice by
    the counts before downloading."""
    return jax.vmap(
        lambda s, n, lo, hi: _compact_one(s, n, lo, hi, vn),
        in_axes=(0, 0, 0, 0))(src_pads, n_reals, los, his)
