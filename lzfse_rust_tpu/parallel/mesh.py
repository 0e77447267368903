"""Multi-chip scale-out: data-parallel block sharding over a device mesh.

The LZFSE container is a concatenation of independent blocks
(src/decode/decoder.rs:79-92), so the natural multi-chip decomposition is
data parallelism over blocks (SURVEY.md §2.3): every chip runs the identical
entropy-decode pipeline on its shard of the block batch; ordered assembly
needs only the block index. Compressed results are fixed-capacity padded, so
the gather of outputs is a plain all-gather along the batch axis; true
lengths ride along as a tiny vector.

This module provides jitted, sharding-annotated versions of the pipeline
stages. There is no NCCL/MPI equivalent to port — XLA inserts the
collectives implied by the shardings (NCCL between GPUs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..base import constants as C
from ..ops.fse_decode import (bytes_to_windows, decode_literals_batch,
                              decode_lmds_batch)
from ..ops.lz_rebuild import lz_rebuild_batch, substitute_distances
from ..ops.table_build import build_decode_tables


def make_mesh(devices=None, axis: str = "blocks") -> Mesh:
    """A 1-D data-parallel mesh over all (or the given) devices."""
    devices = np.array(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def shard_batch(mesh: Mesh, axis: str = "blocks"):
    """NamedSharding that splits the leading (block-batch) dim across chips."""
    return NamedSharding(mesh, P(axis))


@functools.partial(jax.jit, static_argnames=("n_lit_steps", "n_lmd_steps"))
def _entropy_pipeline(weights, lit_payload, lmd_payload, lit_states, lit_pos,
                      lit_num, lmd_states, lmd_pos, lmd_num,
                      n_lit_steps: int, n_lmd_steps: int):
    """Sharded entropy-decode step: table build + literal & LMD scans.

    All inputs are batch-leading; under a mesh sharding of the batch dim each
    chip independently decodes its shard (no cross-chip traffic: blocks are
    independent by format design).
    """
    v_packed, v_base, u_packed = build_decode_tables(weights)
    lit_w = bytes_to_windows(lit_payload)
    lmd_w = bytes_to_windows(lmd_payload)
    literals, lit_fs, lit_fp = decode_literals_batch(
        u_packed, lit_w, lit_states, lit_pos, lit_num, n_lit_steps)
    lmds, lmd_fs, lmd_fp = decode_lmds_batch(
        v_packed, v_base, lmd_w, lmd_states, lmd_pos, lmd_num, n_lmd_steps)
    lmds = lmds.at[:, :, 2].set(substitute_distances(lmds[:, :, 2]))
    ok = ((lit_fs == 0).all(axis=1) & (lit_fp >= 64)
          & (lmd_fs[:, 0] == 0) & (lmd_fs[:, 1] == C.L_STATES)
          & (lmd_fs[:, 2] == C.L_STATES + C.M_STATES) & (lmd_fp >= 64))
    return literals, lmds, ok


def sharded_entropy_decode(mesh: Mesh, arrays: dict, n_lit_steps: int,
                           n_lmd_steps: int, axis: str = "blocks"):
    """Run the entropy pipeline with the block batch sharded over `mesh`.

    `arrays` carries the same host arrays TpuDecoder assembles; the batch dim
    must be divisible by the mesh size.
    """
    sh = shard_batch(mesh, axis)
    put = lambda x: jax.device_put(np.asarray(x), sh)
    return _entropy_pipeline(
        put(arrays["weights"]), put(arrays["lit_payload"]),
        put(arrays["lmd_payload"]), put(arrays["lit_states"]),
        put(arrays["lit_pos"]), put(arrays["lit_num"]),
        put(arrays["lmd_states"]), put(arrays["lmd_pos"]),
        put(arrays["lmd_num"]), n_lit_steps=n_lit_steps,
        n_lmd_steps=n_lmd_steps)


def sharded_rebuild(mesh: Mesh, literals, rows, n_raw, n_out: int,
                    axis: str = "blocks"):
    """Container-parallel LZ reconstruction: each chip rebuilds its shard of
    containers (the per-container row streams are self-contained)."""
    sh = shard_batch(mesh, axis)
    put = lambda x: jax.device_put(np.asarray(x), sh)
    return lz_rebuild_batch(put(literals), put(rows), put(n_raw), n_out)


@functools.partial(jax.jit, static_argnames=("vn",))
def _match_find_batch(src_pad, n_real, vn: bool):
    """Batched window match finding: vmap of the single-window device
    pipeline (ops/match_find_tpu) over a leading window axis."""
    from ..ops.match_find_tpu import find_matches_device
    return jax.vmap(lambda s, n: find_matches_device(s, n, vn))(
        src_pad, n_real)


def sharded_match_find(mesh: Mesh, windows, n_real, vn: bool = False,
                       axis: str = "blocks"):
    """Multi-chip encode front end: windows shard across the mesh and each
    chip runs the candidate/LCP pipeline on its shard (the encode-side data
    parallelism; windows are independent because each carries its own
    history context — models/encoder.py WINDOW_CTX).

    windows: (W, N) uint8 padded; n_real: (W,) int32. Returns the stacked
    per-window (pos, cands, lcps) with the window axis unsharded.
    """
    sh = shard_batch(mesh, axis)
    put = lambda x: jax.device_put(np.asarray(x), sh)
    return _match_find_batch(put(windows), put(n_real), vn)


def sharded_tans_decode(mesh: Mesh, host, n_lit: int, n_lmd: int,
                        interpret: bool = False, axis: str = "blocks"):
    """Multi-device serving decode with the GPU tANS kernels: `host` holds
    (u_tab, v_tab, words, small) arrays with a leading device axis, one
    slice per mesh device (models/decoder._prep_shard); each device runs
    models/decoder.entropy_decode on its slice under shard_map. Blocks are
    independent by format design, so no collective runs; outputs keep the
    leading device axis."""
    sh = shard_batch(mesh, axis)
    run = _tans_decode_fn(mesh, n_lit, n_lmd, interpret, axis)
    return run(*(jax.device_put(x, sh) for x in host))


@functools.lru_cache(maxsize=16)
def _tans_decode_fn(mesh: Mesh, n_lit: int, n_lmd: int, interpret: bool,
                    axis: str):
    from jax import shard_map

    from ..models.decoder import entropy_decode

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(axis),) * 4,
        out_specs=(P(axis),) * 5, check_vma=False)
    def run(u, v, w, s):
        out = entropy_decode(u[0], v[0], w[0], s[0], n_lit=n_lit,
                             n_lmd=n_lmd, interpret=interpret)
        return tuple(x[None] for x in out)

    return run


def sharded_grouped_match(mesh: Mesh, pads, n_reals, los, his, orders, oks,
                          vn: bool = False, axis: str = "blocks"):
    """Multi-device encode front end over the sort-free grouped kernels:
    the window batch shards across the mesh and each device runs the
    no-sort probe + arbitration (ops/match_find_tpu.
    find_matches_grouped_compact) on its shard under shard_map. Windows
    are independent (each carries its own history context), so no
    collectives run until the caller's gather/epilogue. The window count
    must be divisible by the mesh size (callers pad with empty windows)."""
    from jax import shard_map

    from ..ops.match_find_tpu import find_matches_grouped_compact

    sh = shard_batch(mesh, axis)
    put = lambda x: jax.device_put(jnp.asarray(x), sh)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=tuple(P(axis) for _ in range(6)),
        out_specs=tuple(P(axis) for _ in range(5)),
        check_vma=False)
    def run(p, nr, lo, hi, o, k):
        return find_matches_grouped_compact(p, nr, lo, hi, o, k, vn)

    return run(put(pads), put(n_reals), put(los), put(his), put(orders),
               put(oks))


def gather_compressed(mesh: Mesh, padded_blocks, lengths, axis: str = "blocks"):
    """Ordered all-gather of fixed-capacity compressed blocks + true lengths.

    The multi-chip encode epilogue (SURVEY.md §5 'distributed communication
    backend'): per-chip block shards, gathered in block order over the interconnect; host
    compaction then drops the padding using `lengths`.
    """
    from jax import shard_map

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis)), out_specs=(P(), P()),
        check_vma=False)
    def gather(blocks, lens):
        return (jax.lax.all_gather(blocks, axis, axis=0, tiled=True),
                jax.lax.all_gather(lens, axis, axis=0, tiled=True))

    return gather(padded_blocks, lengths)
