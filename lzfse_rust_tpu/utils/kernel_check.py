"""The GPU tANS kernels checked against the plain XLA scans.

decode_case / encode_case build both sides' inputs from real containers or
sources (through the native runtime, as the serving paths do); run_* run
one side; compare_* return the number of blocks on which the two disagree
(payload bytes, decoded symbols, final states and positions — integers, so
agreement must be exact). decode_parts / encode_parts give each kernel and
each scan alone on device-resident inputs, and device_seconds reads their
GPU time from a profiler trace. chip_smoke.py runs them at the serving
batch on the card; the tests run them at small sizes with the kernels
interpreted.
"""

from __future__ import annotations

import numpy as np

from ..base import constants as C


def decode_case(containers: list[bytes]) -> dict:
    """Kernel and reference inputs for every FSE block of `containers`."""
    from ..models import decoder as M
    from ..runtime import native
    native.require()
    desc, w16 = native.walk_batch(containers)[:2]
    nb = len(desc)
    dst = M._payload_layout(desc)
    words = np.empty(M._words_bucket((int(dst[-1]) + M._ALIGN) // 4),
                     np.uint32)
    v_tab, u_tab, small, off_l, off_m = M._prep_shard(
        native, containers, desc, w16, dst, nb, words)
    stage = words.view(np.uint8)
    lit_pay = np.zeros((nb, M.LIT_PAYLOAD_PAD + M._PAD_TAIL), np.uint8)
    lmd_pay = np.zeros((nb, M.LMD_PAYLOAD_PAD + M._PAD_TAIL), np.uint8)
    for b in range(nb):
        for pay, col, n in ((lit_pay, 0, desc[b, 6]), (lmd_pay, 8,
                                                       desc[b, 8])):
            at = int(small[b, col]) * 4
            pay[b, :n] = stage[at:at + n]
    return dict(
        nb=nb, u_tab=u_tab, v_tab=v_tab, words=words, small=small,
        n_lit=M._words_bucket(int(off_l[-1]) + 1),
        n_lmd=M._words_bucket(int(off_m[-1]) + 1),
        weights=w16.astype(np.int32), lit_pay=lit_pay, lmd_pay=lmd_pay)


def run_decode_kernels(case: dict, interpret: bool = False):
    import jax.numpy as jnp

    from ..models.decoder import entropy_decode
    return entropy_decode(
        jnp.asarray(case["u_tab"]), jnp.asarray(case["v_tab"]),
        jnp.asarray(case["words"]), jnp.asarray(case["small"]),
        n_lit=case["n_lit"], n_lmd=case["n_lmd"], interpret=interpret)


def run_decode_reference(case: dict):
    """ops/fse_decode scans with ops/table_build tables (device-built)."""
    import jax.numpy as jnp

    from ..ops.fse_decode import (bytes_to_windows, decode_literals_batch,
                                  decode_lmds_batch)
    from ..ops.table_build import build_decode_tables
    sm = case["small"]
    v_packed, v_base, u_packed = build_decode_tables(
        jnp.asarray(case["weights"]))
    lit = decode_literals_batch(
        u_packed, bytes_to_windows(jnp.asarray(case["lit_pay"])),
        jnp.asarray(sm[:, 4:8]), jnp.asarray(sm[:, 1]),
        jnp.asarray(sm[:, 2]), C.LITERALS_PER_BLOCK // 4)
    lmd = decode_lmds_batch(
        v_packed, v_base, bytes_to_windows(jnp.asarray(case["lmd_pay"])),
        jnp.asarray(sm[:, 12:15]), jnp.asarray(sm[:, 9]),
        jnp.asarray(sm[:, 10]), C.LMDS_PER_BLOCK)
    return lit + lmd


def compare_decode(case: dict, kern, ref) -> int:
    """Blocks whose literals, L/M/D rows, final states or positions differ."""
    sm = case["small"]
    lit_k, lm_k, d_k, lfin, mfin = (np.asarray(x) for x in kern)
    lits_r, lfs_r, lfp_r, lmds_r, mfs_r, mfp_r = (np.asarray(x) for x in ref)
    lit_bytes = lit_k.view(np.uint8)
    bad = 0
    for b in range(case["nb"]):
        n_l, o_l = int(sm[b, 2]), int(sm[b, 3]) * 4
        n_m, o_m = int(sm[b, 10]), int(sm[b, 11])
        rows = lmds_r[b, :n_m]
        ok = (np.array_equal(lit_bytes[o_l:o_l + n_l], lits_r[b, :n_l])
              and np.array_equal(lm_k[o_m:o_m + n_m],
                                 rows[:, 0] | (rows[:, 1] << 16))
              and np.array_equal(d_k[o_m:o_m + n_m], rows[:, 2])
              and np.array_equal(lfin[b, :4], lfs_r[b])
              and lfin[b, 4] == lfp_r[b]
              and np.array_equal(mfin[b, :3], mfs_r[b])
              and mfin[b, 3] == mfp_r[b])
        bad += not ok
    return bad


def encode_case(sources: list[bytes]) -> dict:
    """Emission inputs for every FSE block the native frontend closes on
    `sources`: the kernels' right-justified staging and the reference's
    left-justified literal and (l, m, d) row arrays."""
    from ..models.encoder import TpuEncoder
    from ..runtime import native
    native.require()
    blocks = [blk for src in sources
              for blk in TpuEncoder._parse_blocks(native.frontend_blocks(src))]
    nb = len(blocks)
    n = C.LMDS_PER_BLOCK
    weights = np.zeros((nb, C.N_WEIGHTS), np.int32)
    litw = np.zeros((nb, 4 * n), np.uint8)
    lits_left = np.zeros((nb, 4 * n), np.uint8)
    lmv = np.zeros((nb, n), np.int32)
    dv = np.zeros((nb, n), np.int32)
    rows_left = np.zeros((nb, n, 3), np.int32)
    lit_num = np.zeros(nb, np.int32)
    lmd_num = np.zeros(nb, np.int32)
    for i, (lits, rows3, _) in enumerate(blocks):
        weights[i] = native.block_weights(rows3, lits)[0]
        pad = (-len(lits)) % 4
        padded = np.concatenate(
            [lits, np.full(pad, lits[0] if len(lits) else 0, np.uint8)])
        lit_num[i] = len(padded)
        litw[i, 4 * n - len(padded):] = padded
        lits_left[i, :len(padded)] = padded
        nr = len(rows3)
        lmd_num[i] = nr
        lmv[i, n - nr:] = rows3[:, 0] | (rows3[:, 1] << 16)
        dv[i, n - nr:] = rows3[:, 2]
        rows_left[i, :nr] = rows3
    return dict(nb=nb, weights=weights, litw=litw, lit_num=lit_num, lmv=lmv,
                dv=dv, lmd_num=lmd_num, lits_left=lits_left,
                rows_left=rows_left)


def run_encode_kernels(case: dict, interpret: bool = False):
    import jax.numpy as jnp

    from ..ops import tans_gpu as T
    from ..ops.fse_encode import build_encode_tables
    e_l, e_m, e_d, e_u = build_encode_tables(jnp.asarray(case["weights"]))
    return (T.encode_literals(e_u, jnp.asarray(case["litw"].view("<i4")),
                              jnp.asarray(case["lit_num"]),
                              interpret=interpret)
            + T.encode_lmds(e_l, e_m, e_d, jnp.asarray(case["lmv"]),
                            jnp.asarray(case["dv"]),
                            jnp.asarray(case["lmd_num"]),
                            interpret=interpret))


def run_encode_reference(case: dict):
    import jax.numpy as jnp

    from ..ops.fse_encode import (build_encode_tables, encode_literals_batch,
                                  encode_lmds_batch)
    e_l, e_m, e_d, e_u = build_encode_tables(jnp.asarray(case["weights"]))
    n = C.LMDS_PER_BLOCK
    return (encode_literals_batch(e_u, jnp.asarray(case["lits_left"]),
                                  jnp.asarray(case["lit_num"]), n)
            + encode_lmds_batch(e_l, e_m, e_d,
                                jnp.asarray(case["rows_left"]),
                                jnp.asarray(case["lmd_num"]), n))


def decode_parts(case: dict, interpret: bool = False) -> list:
    """[(name, fn)]: each decode kernel and each XLA scan alone, its inputs
    already on the device (a call is the jitted function and nothing
    else)."""
    import jax.numpy as jnp

    from ..ops import tans_gpu as T
    from ..ops.fse_decode import (bytes_to_windows, decode_literals_batch,
                                  decode_lmds_batch)
    from ..ops.table_build import build_decode_tables
    sm = case["small"]
    c = {j: jnp.asarray(sm[:, j]) for j in (0, 1, 2, 3, 8, 9, 10, 11)}
    lst, mst = jnp.asarray(sm[:, 4:8]), jnp.asarray(sm[:, 12:15])
    u, v, w = (jnp.asarray(case[k]) for k in ("u_tab", "v_tab", "words"))
    vp, vb, up = build_decode_tables(jnp.asarray(case["weights"]))
    lw = bytes_to_windows(jnp.asarray(case["lit_pay"]))
    mw = bytes_to_windows(jnp.asarray(case["lmd_pay"]))
    return [
        ("literal decode kernel", lambda: T.decode_literals(
            u, w, c[0], c[1], lst, c[2], c[3], n_out=case["n_lit"],
            interpret=interpret)),
        ("literal decode XLA scan", lambda: decode_literals_batch(
            up, lw, lst, c[1], c[2], C.LITERALS_PER_BLOCK // 4)),
        ("L/M/D decode kernel", lambda: T.decode_lmds(
            v, w, c[8], c[9], mst, c[10], c[11], n_out=case["n_lmd"],
            interpret=interpret)),
        ("L/M/D decode XLA scan", lambda: decode_lmds_batch(
            vp, vb, mw, mst, c[9], c[10], C.LMDS_PER_BLOCK)),
    ]


def encode_parts(case: dict, interpret: bool = False) -> list:
    """[(name, fn)] as decode_parts, for the emission kernels and scans."""
    import jax.numpy as jnp

    from ..ops import tans_gpu as T
    from ..ops.fse_encode import (build_encode_tables,
                                  encode_literals_batch, encode_lmds_batch)
    e_l, e_m, e_d, e_u = build_encode_tables(jnp.asarray(case["weights"]))
    litw = jnp.asarray(case["litw"].view("<i4"))
    ln, mn = jnp.asarray(case["lit_num"]), jnp.asarray(case["lmd_num"])
    lmv, dv = jnp.asarray(case["lmv"]), jnp.asarray(case["dv"])
    lits = jnp.asarray(case["lits_left"])
    rows = jnp.asarray(case["rows_left"])
    n = C.LMDS_PER_BLOCK
    return [
        ("literal emission kernel", lambda: T.encode_literals(
            e_u, litw, ln, interpret=interpret)),
        ("literal emission XLA scan",
         lambda: encode_literals_batch(e_u, lits, ln, n)),
        ("L/M/D emission kernel", lambda: T.encode_lmds(
            e_l, e_m, e_d, lmv, dv, mn, interpret=interpret)),
        ("L/M/D emission XLA scan",
         lambda: encode_lmds_batch(e_l, e_m, e_d, rows, mn, n)),
    ]


def device_seconds(fn, runs: int = 2) -> dict:
    """GPU time per call of `fn`, from a jax.profiler trace of `runs`
    synchronous calls (after a warm-up call): {name: seconds} for every
    kernel and copy on the device's streams, plus "total", their sum. The
    trace is written to the checkout's .jax_trace/ and removed."""
    import gzip
    import json
    import shutil

    import jax

    from .jax_cache import CHECKOUT
    jax.block_until_ready(fn())
    out = CHECKOUT / ".jax_trace"
    shutil.rmtree(out, ignore_errors=True)
    try:
        with jax.profiler.trace(str(out)):
            for _ in range(runs):
                jax.block_until_ready(fn())
        with gzip.open(next(out.glob("plugins/profile/*/*.trace.json.gz"))) \
                as f:
            ev = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    meta = {(e["name"], e["pid"], e.get("tid")): e["args"]["name"]
            for e in ev if e.get("ph") == "M" and "args" in e
            and "name" in e["args"]}
    times: dict = {}
    for e in ev:
        if (e.get("ph") == "X"
                and meta.get(("process_name", e["pid"], None), "")
                .startswith("/device:GPU")
                and meta.get(("thread_name", e["pid"], e.get("tid")), "")
                .startswith("Stream")):
            times[e["name"]] = times.get(e["name"], 0.0) + e["dur"] * 1e-6
    if not times:
        raise RuntimeError(f"no GPU stream events in the trace; tracks: "
                           f"{sorted(set(meta.values()))[:20]}")
    times = {k: v / runs for k, v in times.items()}
    times["total"] = sum(times.values())
    return times


def compare_encode(case: dict, kern, ref) -> int:
    """Blocks whose packed literal or L/M/D payload bytes, pad bit counts
    or final states differ."""
    from ..ops.fse_encode import pack_bits_host, pack_group_stream
    glo, gmeta, lfs, mlo, mmeta, mfs = (np.asarray(x) for x in kern)
    lout, lst, mout, mst = (np.asarray(x) for x in ref)
    bad = 0
    for b in range(case["nb"]):
        g, r = int(case["lit_num"][b]) // 4, int(case["lmd_num"][b])
        ok = (pack_group_stream(glo[b], gmeta[b], g, 8)
              == pack_bits_host(lout[b, :g].reshape(-1, 2))
              and pack_group_stream(mlo[b], mmeta[b], r, 22)
              == pack_bits_host(mout[b, :r].reshape(-1, 2))
              and np.array_equal(lfs[b] - C.U_STATES, lst[b])
              and np.array_equal(
                  mfs[b] - np.array([C.L_STATES, C.M_STATES, C.D_STATES]),
                  mst[b]))
        bad += not ok
    return bad
