"""TpuEncoder — the batched encode pipeline ("flagship model", encode side).

Division of labor, chosen by backend (ops/tans_gpu.select_path):
  GPU:  the native history-table frontend (match finding, selection, block
        split, weights) per source on host threads, then every FSE block
        of the call in one pass of the tANS emission kernels
        (ops/tans_gpu.py — the reference encoder's hot loop 2) and a native
        bit-pack/assembly pass. With a mesh, match finding runs on the
        devices instead (frontend="device", sharded windows).
  CPU:  device-window match finding in XLA (ops/match_find_tpu.py) and the
        host selection scan + block emission (spec/frontend.py, or native).
Every path preserves the reference's exact semantics — output is
byte-identical to the scalar encoder's.

Inputs above the device window size stream through overlapping windows:
each window carries a 262144-byte history context, which makes the
candidate sets EXACT — a history-table FIFO walk stops at the first
out-of-reach entry (dist > 262139), so probes only ever depend on the last
max_d+3 bytes (the decision-independence argument, spec/match_find.py).
Window-truncated LCPs are re-extended on the full buffer before
arbitration, and one selection+emission pass runs over the concatenated
absolute-coordinate match stream — so the output is byte-identical to the
one-shot scalar encoders at EVERY input size.
"""

from __future__ import annotations

import numpy as np

from ..base import constants as C
from ..spec import frontend as FE
from ..spec import fse as _FSE
from ..spec.match_find import MatchStream

# Device match-window geometry. The padded device array N is static (one
# compiled kernel per bucket); chunks leave 128 bytes of pad headroom.
# 1 MiB windows cover the format's max match distance (262139) with room to
# spare.
WINDOW_N = 1 << 20
WINDOW_CAP = WINDOW_N - 128
# history context carried into each window after the first: covers the
# format's maximum match distance (262139) plus probe width, so candidate
# generation inside the payload region is exact (see module docstring).
# Each chunk also carries a 3-byte overhang past its payload so every
# payload position has its 4-byte probe value in-window.
WINDOW_CTX = 1 << 18
WINDOW_STRIDE = WINDOW_CAP - WINDOW_CTX - 3

# reusable pooled emission staging, keyed by padded block count (see
# _emit_blocks_device; decode_many's _PREP_CACHE is the same idiom)
_EMIT_CACHE: dict = {}
# staging pools for the fused native frontend+stage serving path
# (_encode_many_staged), keyed by padded slot count
_STAGE_CACHE: dict = {}


def _bucket_pow2(x: int, lo: int = 4096) -> int:
    x = max(x, lo)
    return 1 << (x - 1).bit_length()


def _parallel_blocks(fn, n: int, use_threads: bool = True) -> None:
    """Run fn(i) for i in range(n), fanning out across host threads when the
    batch is big enough to amortize pool startup. Every fn writes only its
    own index's slots, and the native per-block calls (tl_block_weights,
    tl_pack_groups) release the GIL, so the hot work overlaps.
    use_threads=False (no native runtime resolved) keeps the loop serial:
    pure-Python/numpy bodies hold the GIL, so a pool only adds dispatch."""
    if n < 16 or not use_threads:
        for i in range(n):
            fn(i)
        return
    import concurrent.futures as _cf
    import os as _os
    with _cf.ThreadPoolExecutor(_os.cpu_count() or 1) as ex:
        # list() propagates the first worker exception, matching serial
        list(ex.map(fn, range(n)))


def _emission_kernels(weights, litw, lit_num, lmv, dv, lmd_num):
    """Run both tANS emission kernels over a pool of staged blocks and
    download their group streams: (glo, gmeta, lfs, mlo, mmeta, mfs) host
    arrays in slot order (ops/tans_gpu.encode_literals / encode_lmds)."""
    import jax.numpy as jnp

    from ..ops import tans_gpu as T
    from ..ops.fse_encode import build_encode_tables

    e_l, e_m, e_d, e_u = build_encode_tables(jnp.asarray(weights))
    lit = T.encode_literals(e_u, jnp.asarray(litw.view("<i4")),
                            jnp.asarray(lit_num), interpret=T.INTERPRET)
    lmd = T.encode_lmds(e_l, e_m, e_d, jnp.asarray(lmv), jnp.asarray(dv),
                        jnp.asarray(lmd_num), interpret=T.INTERPRET)
    return tuple(np.ascontiguousarray(np.asarray(x)) for x in lit + lmd)


class TpuEncoder:
    """Container encoder with device-side tANS block emission on the GPU
    and a selectable match-finding front end.

    The backend decides emission (ops/tans_gpu.select_path): on "gpu" every
    FSE block of a call goes through one pass of the emission kernels and
    the native runtime is required (a failed build raises); on "cpu" blocks
    are emitted on the host. `last_emission` names what the last call did
    ("device" or "host").

    frontend="native" (the GPU default): the history-table frontend runs
    natively per source — ctypes releases the GIL, so sources parallelize
    across a host pool — and every resulting block pools into one device
    emission pass (the reference encoder's hot loop 2 — literals.rs:93-133,
    lmds.rs:62-93). frontend="device" (the CPU and mesh default): windowed
    decision-independent match finding on the devices
    (ops/match_find_tpu.py) + native selection. Either way output is
    byte-identical to the native/spec encoders at every size."""

    def __init__(self, frontend: str | None = None, mesh=None):
        """mesh: optional jax.sharding.Mesh. With frontend="device", the
        match-finder window batch of every encode shards across the mesh
        and each device runs the sort-free grouped probe kernels under
        shard_map (parallel/mesh.sharded_grouped_match) — the encode-side
        composed multi-device capability (SURVEY.md §7 stage 6; windows are
        independent, each carrying its own history context)."""
        import jax.numpy as jnp
        from ..ops import tans_gpu
        self._jnp = jnp
        self.mesh = mesh
        self.device_emission = tans_gpu.select_path() == "gpu"
        if self.device_emission:
            from ..runtime import native
            native.require()
        if frontend is None:
            frontend = ("native" if self.device_emission and mesh is None
                        else "device")
        assert frontend in ("native", "device")
        self.frontend = frontend
        self.last_emission = None

    @staticmethod
    def _window_geometry(n_full: int, start: int):
        """(base, ctx, n, N) for the device window probing
        src[start : start+stride] with its history context."""
        ctx = min(start, WINDOW_CTX)
        base = start - ctx
        n = min(n_full, start + WINDOW_STRIDE + 3) - base
        N = min(_bucket_pow2(n + 128), WINDOW_N)
        assert n + 128 <= N
        return base, ctx, n, N

    def _window_matches(self, full: np.ndarray, start: int, vn: bool):
        """Exact absolute-coordinate match rows for src[start : start+stride].

        The device probes [start-ctx, start+stride); rows below `start` are
        context-only (their pushes shape the candidate FIFOs, their probes
        are discarded). Window-truncated forward LCPs are re-extended on the
        full buffer BEFORE the FIFO strict-`>` arbitration, so candidate
        choice matches the one-shot scan exactly.
        """
        import jax.numpy as jnp
        from ..ops.match_find_tpu import find_matches_device

        n_full = len(full)
        base, ctx, n, N = self._window_geometry(n_full, start)
        src_pad = np.zeros(N, dtype=np.uint8)
        src_pad[:n] = full[base:base + n]
        pos, cands, lcps = find_matches_device(
            jnp.asarray(src_pad), jnp.int32(n), vn)
        return self._arbitrate_window(
            full, base, ctx, n, np.asarray(pos), np.asarray(cands),
            np.asarray(lcps), vn)

    def _arbitrate_window(self, full: np.ndarray, base: int, ctx: int,
                          n: int, pos, cands, lcps, vn: bool):
        """Host half of one window: payload filtering, exact re-extension
        of window-saturated LCPs, FIFO strict-max arbitration."""
        from ..ops.match_find_tpu import WINDOW
        from ..spec.match_find import _lcp_forward

        n_full = len(full)
        pos = pos.astype(np.int64)
        cands = cands.astype(np.int64)
        lcps = lcps.astype(np.int64)

        # only payload-region probes count; context and overhang probes are
        # discarded (the overhang belongs to the next window's payload)
        payload = (pos >= ctx) & (pos < ctx + WINDOW_STRIDE)
        pos = pos[payload]
        cands = cands[:, payload]
        lcps = lcps[:, payload]
        abs_pos = pos + base

        best_len = np.zeros(len(pos), np.int64)
        best_cand = np.zeros(len(pos), np.int64)
        for r in range(cands.shape[0]):
            cand_r, lcp_r = cands[r], lcps[r]
            abs_cand = cand_r + base
            # a device LCP is truncated if it hit the 64-byte row gather
            # window OR the chunk end; both re-extend against the full
            # buffer with the block-end cap (frontend_bytes.rs:253)
            sat = np.flatnonzero(
                (cand_r >= 0) & (abs_pos + lcp_r < n_full)
                & ((lcp_r == WINDOW) | (pos + lcp_r >= n)))
            if len(sat):
                lcp_r[sat] = _lcp_forward(
                    full, abs_pos[sat], abs_cand[sat], lcp_r[sat],
                    (n_full - abs_pos[sat]).astype(np.int64))
            if vn:
                mlen = np.where(lcp_r >= 4, lcp_r,
                                np.where(lcp_r == 3, 3, 0))
            else:
                mlen = np.where(lcp_r >= 4, lcp_r, 0)
            mlen = np.where(cand_r >= 0, mlen, 0)
            take = mlen > best_len
            best_len[take] = mlen[take]
            best_cand[take] = abs_cand[take]

        keep = best_len > 0
        return abs_pos[keep], best_cand[keep], best_len[keep]

    def _windows_compact(self, fulls: dict, wins: list, vn: bool,
                         stats: dict | None = None) -> dict:
        """Batched compact match finding over (src_idx, base, ctx, n, N)
        windows: device-side arbitration, count-bounded downloads, exact
        host re-arbitration only for the saturated rows. Returns window
        index -> (abs_pos, best_cand, best_len).

        `stats` (optional) accumulates wall seconds per stage: win_prep
        (host pad staging), matchfind (device dispatch + downloads),
        arbitrate (host re-extension + FIFO arbitration)."""
        import os as _os
        from ..runtime import native as _nat
        if (_nat.available()
                and _os.environ.get("LZT_DEV_GROUPED", "1") == "1"):
            # sort-free path: host counting-sort grouping + no-sort
            # device kernels (the argsort path below is the no-native
            # path)
            return self._windows_compact_grouped(fulls, wins, vn, stats)
        import time as _time
        import jax.numpy as jnp
        from ..ops.match_find_tpu import find_matches_compact

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        by_n: dict = {}
        for k, w in enumerate(wins):
            by_n.setdefault(w[4], []).append(k)
        out: dict = {}
        for N, idxs in sorted(by_n.items()):
            pads = np.zeros((len(idxs), N), dtype=np.uint8)
            n_reals = np.empty(len(idxs), np.int32)
            los = np.empty(len(idxs), np.int32)
            his = np.empty(len(idxs), np.int32)
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                pads[r, :n] = fulls[i][base:base + n]
                n_reals[r] = n
                los[r] = ctx
                his[r] = ctx + WINDOW_STRIDE
            _mark("win_prep")
            counts, pos_s, cand_s, len_s, cands_s, lcps_s = \
                find_matches_compact(jnp.asarray(pads),
                                     jnp.asarray(n_reals),
                                     jnp.asarray(los), jnp.asarray(his),
                                     vn)
            counts_h = np.asarray(counts)
            # bucketed slice widths keep the jit shape count bounded
            kmax = min(_bucket_pow2(max(int(counts_h[:, 1].max()), 1),
                                    4096), N)
            smax = min(_bucket_pow2(max(int(counts_h[:, 0].max()), 1),
                                    1024), N)
            pos_h = np.asarray(pos_s[:, :kmax]).astype(np.int64)
            cand_h = np.asarray(cand_s[:, :kmax]).astype(np.int64)
            len_h = np.asarray(len_s[:, :kmax]).astype(np.int64)
            cands_h = np.asarray(cands_s[:, :, :smax])
            lcps_h = np.asarray(lcps_s[:, :, :smax])
            if stats is not None:
                stats["download_bytes"] = stats.get("download_bytes", 0) + (
                    pos_h.nbytes // 2 + cand_h.nbytes // 2
                    + len_h.nbytes // 2 + cands_h.nbytes + lcps_h.nbytes)
            _mark("matchfind")
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                S, K = int(counts_h[r, 0]), int(counts_h[r, 1])
                if S:
                    sp, sc, sl = self._arbitrate_window(
                        fulls[i], base, ctx, n, pos_h[r, :S],
                        cands_h[r, :, :S], lcps_h[r, :, :S], vn)
                else:
                    sp = sc = sl = np.zeros(0, np.int64)
                dp = pos_h[r, S:K] + base
                dc = cand_h[r, S:K] + base
                dl = len_h[r, S:K]
                out[k] = (np.concatenate([sp, dp]),
                          np.concatenate([sc, dc]),
                          np.concatenate([sl, dl]))
            _mark("arbitrate")
        return out

    def _windows_compact_grouped(self, fulls: dict, wins: list, vn: bool,
                                 stats: dict | None = None) -> dict:
        """Sort-free batched window match finding. The grouped path runs
        no device sort over the window's positions:

          host:   bucket grouping as a GIL-free native counting sort per
                  window (runtime/native.match_group — the exact stable
                  argsort-by-bucket replacement), pooled across windows;
          device: candidate windows + LCP row gathers + FIFO strict-max
                  arbitration with NO sorts, returning per-slot key bytes
                  + packed rows (ops/match_find_tpu.
                  find_matches_grouped_compact);
          host:   reads the key bytes, then directs ONE bounded row-gather
                  download at exactly the sat/matched slots it needs
                  (ops/match_find_tpu.take_sat_cols).

        Same return contract and byte-exact same match streams as
        _windows_compact's argsort path (tests/test_tpu_encoder.py)."""
        import concurrent.futures as _cf
        import os as _os
        import time as _time
        import jax.numpy as jnp
        from ..ops.match_find_tpu import (find_matches_grouped_compact,
                                          take_sat_cols)
        from ..runtime import native

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        by_n: dict = {}
        for k, w in enumerate(wins):
            by_n.setdefault(w[4], []).append(k)
        out: dict = {}
        for N, idxs in sorted(by_n.items()):
            B = len(idxs)
            pads = np.zeros((B, N), dtype=np.uint8)
            n_reals = np.empty(B, np.int32)
            los = np.empty(B, np.int32)
            his = np.empty(B, np.int32)
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                pads[r, :n] = fulls[i][base:base + n]
                n_reals[r] = n
                los[r] = ctx
                his[r] = ctx + WINDOW_STRIDE
            # host grouping: GIL-free counting sorts, pooled across windows
            orders = np.empty((B, N), np.int32)
            oks = np.empty((B, N), np.uint8)

            def _g(r):
                orders[r], oks[r] = native.match_group(
                    pads[r], int(n_reals[r]), vn)

            if B > 1:
                with _cf.ThreadPoolExecutor(
                        min(B, _os.cpu_count() or 1)) as ex:
                    list(ex.map(_g, range(B)))
            else:
                _g(0)
            _mark("win_prep")
            if self.mesh is not None:
                # shard the window batch across the mesh (pad with empty
                # windows to a whole number of shards; ok=0 and an empty
                # payload range make pad rows inert)
                from ..parallel.mesh import sharded_grouped_match
                ms = self.mesh.size
                Bk = -(-B // ms) * ms
                if Bk != B:
                    pad = Bk - B
                    pads = np.concatenate(
                        [pads, np.zeros((pad, N), np.uint8)])
                    n_reals = np.concatenate(
                        [n_reals, np.full(pad, 4, np.int32)])
                    los = np.concatenate([los, np.zeros(pad, np.int32)])
                    his = np.concatenate([his, np.zeros(pad, np.int32)])
                    orders = np.concatenate(
                        [orders, np.tile(np.arange(N, dtype=np.int32),
                                         (pad, 1))])
                    oks = np.concatenate(
                        [oks, np.zeros((pad, N), np.uint8)])
                keys, bc, bl, cands_d, lcps_d = sharded_grouped_match(
                    self.mesh, pads, n_reals, los, his, orders, oks, vn)
            else:
                Bk = B
                keys, bc, bl, cands_d, lcps_d = find_matches_grouped_compact(
                    jnp.asarray(pads), jnp.asarray(n_reals),
                    jnp.asarray(los), jnp.asarray(his),
                    jnp.asarray(orders), jnp.asarray(oks), vn)
            keys_h = np.asarray(keys)[:B]
            bc_h = np.asarray(bc)[:B]
            bl_h = np.asarray(bl)[:B]
            sat_idx = []
            mat_idx = []
            for r in range(B):
                kr = keys_h[r]
                sat_idx.append(np.flatnonzero(kr == 0).astype(np.int32))
                mat_idx.append(np.flatnonzero(kr == 1).astype(np.int32))
            # only the rare sat slots need their candidate columns; the
            # bucketed width keeps the jit shape count bounded
            smax = min(_bucket_pow2(
                max(max((len(s) for s in sat_idx), default=1), 1), 1024), N)
            idx9 = np.zeros((Bk, smax), np.int32)  # Bk >= B: mesh padding
            for r in range(B):
                idx9[r, :len(sat_idx[r])] = sat_idx[r]
            cands_s, lcps_s = take_sat_cols(cands_d, lcps_d,
                                            jnp.asarray(idx9))
            cands_sh = np.asarray(cands_s)
            lcps_sh = np.asarray(lcps_s)
            if stats is not None:
                stats["download_bytes"] = stats.get("download_bytes", 0) + (
                    keys_h.nbytes + bc_h.nbytes + bl_h.nbytes
                    + cands_sh.nbytes + lcps_sh.nbytes)
            _mark("matchfind")
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                s_i, m_i = sat_idx[r], mat_idx[r]
                S = len(s_i)
                if S:
                    sp, sc, sl = self._arbitrate_window(
                        fulls[i], base, ctx, n,
                        orders[r][s_i].astype(np.int64),
                        cands_sh[r, :, :S], lcps_sh[r, :, :S], vn)
                else:
                    sp = sc = sl = np.zeros(0, np.int64)
                dp = orders[r][m_i].astype(np.int64) + base
                dc = bc_h[r][m_i].astype(np.int64) + base
                dl = bl_h[r][m_i].astype(np.int64)
                out[k] = (np.concatenate([sp, dp]),
                          np.concatenate([sc, dc]),
                          np.concatenate([sl, dl]))
            _mark("arbitrate")
        return out

    def _device_matches(self, src: bytes, vn: bool) -> MatchStream:
        """Full-buffer match stream via overlapping device windows (all
        windows of the buffer batch into one dispatch per size bucket)."""
        from ..spec.match_find import _lcp_backward

        full = np.frombuffer(src, dtype=np.uint8)
        wins = []
        for start in range(0, len(src), WINDOW_STRIDE):
            base, ctx, n, N = self._window_geometry(len(src), start)
            wins.append((0, base, ctx, n, N))
        win_out = self._windows_compact({0: full}, wins, vn)
        parts = [win_out[k] for k in range(len(wins))]
        pos_k = np.concatenate([p for p, _, _ in parts])
        cand_k = np.concatenate([c for _, c, _ in parts])
        fwd_k = np.concatenate([f for _, _, f in parts])
        back_k = _lcp_backward(full, pos_k, cand_k,
                               np.minimum(cand_k, pos_k))
        order = np.argsort(pos_k, kind="stable")
        return MatchStream(
            pos=pos_k[order], match_pos=cand_k[order],
            fwd_len=fwd_k[order], back_max=back_k[order],
        )

    @staticmethod
    def _encode_small(src: bytes) -> bytes:
        """LZVN/raw host path for <= VN_CUTOFF inputs (blocks <= 4 KiB by
        design): native engine when built (byte-identical to the spec,
        enforced by tests; ~160x faster), spec otherwise."""
        from ..runtime import native
        if native.available():
            return native.encode_bytes(src)
        return FE.encode_bytes(src)

    def encode_bytes(self, src: bytes) -> bytes:
        if len(src) <= C.VN_CUTOFF:
            return self._encode_small(src)
        eos = C.MAGIC_EOS.to_bytes(4, "little")
        if self.frontend == "native" and self.device_emission:
            from ..runtime import native
            blocks = self._parse_blocks(native.frontend_blocks(src))
            self.last_emission = "device"
            return b"".join(self._emit_best_device(blocks)) + eos
        stream = self._device_matches(src, vn=False)
        if self.device_emission:
            body = b"".join(self._emit_best_device(
                self._select_blocks(src, stream)))
            self.last_emission = "device"
        else:
            body = self._select_emit(src, stream)
            self.last_emission = "host"
        return body + eos

    def encode_many(self, sources: list[bytes],
                    stats: dict | None = None) -> list[bytes]:
        """Batched container encode — the encode-side serving API.

        Every match-finder window of every source dispatches in ONE
        batched device call per window-size bucket, and with device
        emission every FSE block of every source runs in one pooled
        emission pass — per-dispatch latency amortizes across the whole
        batch. Output is byte-identical to encode_bytes for each source.

        `stats` (optional) accumulates wall seconds per pipeline stage
        (small / frontend / emit_prep / emit_kernels / pack on the GPU
        serving path; win_prep / matchfind / arbitrate / merge / select on
        the device-frontend path)."""
        import time as _time

        from ..spec.match_find import _lcp_backward

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        results: list = [None] * len(sources)
        big: list[int] = []
        for i, s in enumerate(sources):
            if len(s) <= C.VN_CUTOFF:
                results[i] = self._encode_small(s)
            else:
                big.append(i)
        _mark("small")
        if not big:
            return results
        eos = C.MAGIC_EOS.to_bytes(4, "little")

        if self.frontend == "native" and self.device_emission:
            # serving default: fused native frontend+staging per source
            # (tl_frontend_stage — match finding, selection, block split,
            # weights, V2 weight payload, and pooled-array staging all in
            # one GIL-free native pass), then ONE pooled device emission
            # pass and native group packing
            return self._encode_many_staged(sources, big, results, stats)

        # gather every window of every big source, bucketed by padded size
        wins: list[tuple] = []  # (src_idx, base, ctx, n, N)
        fulls = {i: np.frombuffer(sources[i], dtype=np.uint8) for i in big}
        for i in big:
            n_full = len(sources[i])
            for start in range(0, n_full, WINDOW_STRIDE):
                base, ctx, n, N = self._window_geometry(n_full, start)
                wins.append((i, base, ctx, n, N))
        _mark("win_prep")
        win_out = self._windows_compact(fulls, wins, False, stats=stats)

        # per-source: merge windows into one absolute-coordinate stream
        _t0 = _time.perf_counter()
        streams: dict = {}
        for i in big:
            parts = [win_out[k] for k, w in enumerate(wins) if w[0] == i]
            pos_k = np.concatenate([p for p, _, _ in parts])
            cand_k = np.concatenate([c for _, c, _ in parts])
            fwd_k = np.concatenate([f for _, _, f in parts])
            back_k = _lcp_backward(fulls[i], pos_k, cand_k,
                                   np.minimum(cand_k, pos_k))
            order = np.argsort(pos_k, kind="stable")
            streams[i] = MatchStream(
                pos=pos_k[order], match_pos=cand_k[order],
                fwd_len=fwd_k[order], back_max=back_k[order])
        _mark("merge")

        if self.device_emission:
            # pool every source's blocks into ONE emission pass; blocks
            # with a period-split candidate emit both variants in the same
            # pass (emit_best semantics on device)
            per_src_blocks = {i: self._select_blocks(sources[i], streams[i])
                              for i in big}
            _mark("select")
            flat: list = []
            spans: dict = {}
            for i in big:
                spans[i] = (len(flat), len(per_src_blocks[i]))
                flat.extend(per_src_blocks[i])
            bodies = self._emit_best_device(flat, stats=stats)
            _t0 = _time.perf_counter()
            for i in big:
                off, cnt = spans[i]
                results[i] = b"".join(bodies[off:off + cnt]) + eos
            _mark("pack")
            self.last_emission = "device"
            return results
        self.last_emission = "host"
        for i in big:
            results[i] = self._select_emit(sources[i], streams[i]) + eos
        return results

    def _encode_many_staged(self, sources, big, results, stats=None):
        """Serving encode path: per source, ONE fused native call runs the
        history-table frontend and stages every closed block (plus its
        period-split alt variant) directly into the pooled device-emission
        arrays (native.frontend_stage — GIL-free, so staging overlaps
        other sources' frontends across the host pool); then one pooled
        device emission pass and native group packing. Byte-identical to
        encode_bytes per source (reference hot loops:
        src/encode/frontend_bytes.rs:160-244, src/fse/literals.rs:93-133)."""
        import concurrent.futures as _cf
        import os as _os
        import time as _time

        from ..base.errors import LzfseError
        from ..runtime import native

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t

        n_cols = C.LMDS_PER_BLOCK
        eos = C.MAGIC_EOS.to_bytes(4, "little")
        # every closed block consumes >= 40000 source bytes (10000 rows of
        # >= 4-byte matches, or the 40000-literal cap), +1 finalize block;
        # the slack covers period-split alt slots (rare). On overflow the
        # native call errors and we retry with a doubled pool.
        bound = sum(len(sources[i]) // 40000 + 2 for i in big) + 32
        while True:
            B = _bucket_pow2(bound, 32)
            bufs = _STAGE_CACHE.get(B)
            if bufs is None:
                bufs = (np.zeros((B, C.N_WEIGHTS), np.int64),
                        np.zeros((B, n_cols * 4), np.uint8),
                        np.zeros(B, np.int32),
                        np.zeros((B, n_cols), np.int32),
                        np.zeros((B, n_cols), np.int32),
                        np.zeros(B, np.int32),
                        np.zeros((B, 4), np.int32),
                        np.zeros((B, 640), np.uint8),
                        np.zeros(B, np.int32))
                _STAGE_CACHE[B] = bufs
            weights_np, litw, lit_num, lmv, dv, lmd_num, meta, wpay, \
                wpay_len = bufs
            counter = np.zeros(1, np.int64)
            out_lists = {i: np.zeros(len(sources[i]) // 40000 + 2,
                                     np.int32) for i in big}
            nb_of: dict = {}
            try:
                with _cf.ThreadPoolExecutor(
                        min(len(big), _os.cpu_count() or 1)) as ex:
                    for i, nbase in zip(big, ex.map(
                            lambda i: native.frontend_stage(
                                sources[i], bufs, counter, out_lists[i]),
                            big)):
                        nb_of[i] = nbase
                break
            except LzfseError:
                if bound > (1 << 20):
                    raise
                bound *= 2
        nb = int(counter[0])
        _mark("frontend")

        # the slot pool is filled in [0, nb): upload a bucketed prefix
        Bk = min(_bucket_pow2(max(nb, 1), 32), B)
        lit_num[nb:Bk] = 0
        lmd_num[nb:Bk] = 0
        glo, gmeta, lfs, mlo, mmeta, mfs = _emission_kernels(
            weights_np[:Bk], litw[:Bk], lit_num[:Bk], lmv[:Bk], dv[:Bk],
            lmd_num[:Bk])
        _mark("emit_kernels")

        # one native call packs every slot's group streams AND assembles
        # the complete Vx2 bodies, parallel across the worker pool
        arena = _STAGE_CACHE.get(("arena", Bk))
        if arena is None:
            arena = np.empty(Bk * native.PACK_SLOT_CAP, np.uint8)
            _STAGE_CACHE[("arena", Bk)] = arena
        lens = np.zeros(max(nb, 1), np.int64)
        native.pack_stage(glo, gmeta, mlo, mmeta, lfs, mfs, lit_num,
                          lmd_num, meta, wpay, wpay_len, nb, arena, lens)
        av = arena.view()
        body = lambda s: av[s * native.PACK_SLOT_CAP:
                            s * native.PACK_SLOT_CAP + int(lens[s])]
        for i in big:
            parts = []
            for s in out_lists[i][:nb_of[i]]:
                s = int(s)
                a = body(s)
                alt = int(meta[s, 2])
                # emit_best: the strictly smaller variant wins, ties keep
                # the as-is form
                if alt >= 0 and int(lens[alt]) < len(a):
                    a = body(alt)
                parts.append(a)
            results[i] = b"".join(parts) + eos
        _mark("pack")
        self.last_emission = "device"
        return results

    @staticmethod
    def _parse_blocks(blob: bytes):
        """Raw block contents from a select_blocks/frontend_blocks blob:
        [(lits u8[], rows3 int32[n,3], n_match_bytes), ...]."""
        blocks = []
        rec = np.dtype([("l", "<u2"), ("m", "<u2"), ("d", "<u4")])
        off = 0
        n = len(blob)
        while off < n:
            n_lit, n_lmd, n_mb = np.frombuffer(blob, np.uint32, 3, off)
            off += 12
            lits = np.frombuffer(blob, np.uint8, int(n_lit), off)
            off += int(n_lit)
            raw = np.frombuffer(blob, rec, int(n_lmd), off)
            off += 8 * int(n_lmd)
            rows3 = np.stack([raw["l"], raw["m"], raw["d"]],
                             axis=1).astype(np.int32)
            blocks.append((lits, rows3, int(n_mb)))
        return blocks

    def _select_blocks(self, src: bytes, stream: MatchStream):
        """Native selection + block splitting without emission: the raw
        per-block contents the device emission plane consumes."""
        from ..runtime import native

        rows = np.stack([stream.pos, stream.match_pos, stream.fwd_len,
                         stream.back_max], axis=1)
        return self._parse_blocks(native.select_blocks(src, rows))

    def _emit_best_device(self, blocks, stats: dict | None = None) -> list:
        """Pooled device emission with the period-split decision
        (FseBackend::emit_best): a block with an eligible candidate (some
        logical match of running distance 4..15 and length > distance)
        emits BOTH row forms in the same pooled kernel pass and the
        strictly smaller body wins (ties keep the as-is form) — byte-
        identical to the host engines' emit_best while every block stays
        on device. Eligible blocks are rare (6/35 on the Snappy corpus),
        so the pass grows by at most a few rows."""
        flat = list(blocks)
        alt_of: dict[int, int] = {}
        for bi, (lits, rows, n_mb) in enumerate(blocks):
            alt = _FSE.period_split_rows(rows)
            if alt is not None:
                alt_of[bi] = len(flat)
                flat.append((lits, alt, n_mb))
        bodies = self._emit_blocks_device(flat, stats=stats)
        out = []
        for bi in range(len(blocks)):
            a = bodies[bi]
            j = alt_of.get(bi)
            if j is not None and len(bodies[j]) < len(a):
                a = bodies[j]
            out.append(a)
        return out

    def _emit_device(self, src: bytes, stream: MatchStream) -> bytes:
        """Device tANS block emission for one source (see
        _emit_best_device)."""
        return b"".join(self._emit_best_device(
            self._select_blocks(src, stream)))

    def _emit_blocks_device(self, blocks, stats: dict | None = None) -> list:
        """Device tANS block emission: the emission kernels run every
        block's literal + LMD streams at once (blocks may span MANY sources
        — the encode_many path pools them into one dispatch); the host
        packs the group streams and assembles headers/weights (reference
        hot loop 2: src/fse/literals.rs:93-133, lmds.rs:62-93).
        Byte-identical to the scalar emission path. Returns one bytes per
        block."""
        import time as _time

        _t0 = _time.perf_counter()

        def _mark(key):
            nonlocal _t0
            t = _time.perf_counter()
            if stats is not None:
                stats[key] = stats.get(key, 0.0) + (t - _t0)
            _t0 = t
        from ..ops.fse_encode import pack_group_stream
        from ..spec import fse as F
        from ..spec import weights as W

        nb = len(blocks)
        B = _bucket_pow2(nb, 32)
        n_cols = C.LMDS_PER_BLOCK
        from ..runtime import native as _nat
        if not _nat.available():
            _nat = None
        # cached staging: a fresh np.zeros of the ~60MB pooled arrays per
        # call cost more than the native histograms. Stale content outside
        # each block's right-justified active region is never read by the
        # kernels (steps stop at each block's count), so only the
        # per-block COUNTS need re-zeroing.
        bufs = _EMIT_CACHE.get(B)
        if bufs is None:
            bufs = (np.zeros((B, C.N_WEIGHTS), np.int64),
                    np.zeros((B, n_cols * 4), np.uint8),
                    np.zeros(B, np.int32),
                    np.zeros((B, n_cols), np.int32),
                    np.zeros((B, n_cols), np.int32),
                    np.zeros(B, np.int32))
            _EMIT_CACHE[B] = bufs
        weights_np, litw, lit_num, lmv, dv, lmd_num = bufs
        lit_num[:] = 0
        lmd_num[:] = 0
        w_payloads: list = [b""] * nb

        def _stage_one(i):
            lits, rows3, _ = blocks[i]
            if _nat is not None:
                w16, w_payloads[i] = _nat.block_weights(rows3, lits)
                weights_np[i] = w16
            else:
                weights_np[i] = W.weights_from_block(rows3, lits)
            n_lit = len(lits)
            pad = (-n_lit) % 4
            pad_byte = lits[0] if n_lit else np.uint8(0)
            g = (n_lit + pad) // 4
            start = n_cols * 4 - g * 4
            litw[i, start:start + n_lit] = lits
            if pad:
                litw[i, start + n_lit:start + n_lit + pad] = pad_byte
            lit_num[i] = n_lit + pad
            nr = len(rows3)
            lmv[i, n_cols - nr:] = rows3[:, 0] | (rows3[:, 1] << 16)
            dv[i, n_cols - nr:] = rows3[:, 2]
            lmd_num[i] = nr

        # each block writes a disjoint row of the pooled arrays and the
        # native histogram (tl_block_weights) releases the GIL, so blocks
        # stage in parallel across the host cores (serial without the
        # native runtime: the numpy fallback bodies hold the GIL)
        _parallel_blocks(_stage_one, nb, use_threads=_nat is not None)
        _mark("emit_prep")
        glo, gmeta, lfs, mlo, mmeta, mfs = _emission_kernels(
            weights_np, litw, lit_num, lmv, dv, lmd_num)
        _mark("emit_kernels")

        pack = _nat.pack_groups if _nat is not None else pack_group_stream
        out: list = [b""] * nb

        def _pack_one(i):
            lits, rows3, n_mb = blocks[i]
            padded = int(lit_num[i])
            g = padded // 4
            lit_pay, lit_off = pack(glo[i], gmeta[i], g, 8)
            lmd_pay, lmd_off = pack(mlo[i], mmeta[i], int(lmd_num[i]), 22)
            lmd_pay = b"\x00" * 8 + lmd_pay
            lit_param = F.LiteralParam(
                num=padded, n_payload_bytes=len(lit_pay), bits=lit_off,
                state=tuple(int(s) - C.U_STATES for s in lfs[i, :4]))
            lmd_param = F.LmdParam(
                num=int(lmd_num[i]), n_payload_bytes=len(lmd_pay),
                bits=lmd_off,
                state=(int(mfs[i, 0]) - C.L_STATES,
                       int(mfs[i, 1]) - C.M_STATES,
                       int(mfs[i, 2]) - C.D_STATES))
            block = F.FseBlock(lit_param, lmd_param, len(lits) + n_mb)
            weight_payload = w_payloads[i] or W.store_v2(weights_np[i])
            out[i] = b"".join((
                F.store_v2_header(block, len(weight_payload)),
                weight_payload, lit_pay, lmd_pay))

        # tl_pack_groups releases the GIL; blocks pack independently
        _parallel_blocks(_pack_one, nb, use_threads=_nat is not None)
        _mark("pack")
        return out

    def _select_emit(self, chunk: bytes, stream: MatchStream) -> bytes:
        """Selection scan + block emission (native fast path, spec fallback).
        Both preserve the reference semantics exactly."""
        from ..runtime import native
        if native.available():
            rows = np.stack([stream.pos, stream.match_pos,
                             stream.fwd_len, stream.back_max], axis=1)
            return native.select_emit_fse(chunk, rows)
        matches = FE.select_matches(stream, len(chunk))
        arr = np.frombuffer(chunk, dtype=np.uint8)
        blocks: list[bytes] = []

        def emit_block(literals, lmds, n_raw):
            from ..spec import fse as F
            blocks.append(F.encode_block(literals, lmds, n_raw))

        buf = FE.FseBuffer(arr, emit_block)
        FE.emit_lmd_stream(arr, matches, buf)
        return b"".join(blocks)
