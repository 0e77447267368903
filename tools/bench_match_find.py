"""Device match-finder throughput on one 1 MiB window of the seeded corpus
(frontend="device" in models/encoder.py): the argsort pipeline and the
sort-free grouped pipeline, timed by repetition inside one jit (the
difference of 5 and 1 repetitions removes the dispatch and the download).

    python tools/bench_match_find.py
"""
import os, sys, pathlib, time, functools
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import numpy as np
import jax, jax.numpy as jnp
from lzfse_rust_tpu.ops.match_find_tpu import find_matches_device
from lzfse_rust_tpu.runtime import native
from lzfse_rust_tpu.utils import corpus, jax_cache

jax_cache.enable()
print(f"device: {jax.devices()[0].device_kind}", flush=True)
raws = [r for _, r in corpus.generate(0)]
data = (b"".join(raws) * 1)[: (1 << 20) - 128]
N = 1 << 20
src = np.zeros(N, np.uint8)
src[:len(data)] = np.frombuffer(data, np.uint8)
S = jnp.asarray(src)
n = jnp.int32(len(data))

def dep(acc):
    """Iteration-to-iteration data dependency XLA cannot fold (the
    `X + r - r` idiom is structurally zero and lets the whole body hoist
    out of the fori_loop — observed as ~0/negative deltas). Runtime 0."""
    return jnp.where(acc == jnp.int32(-123456789), jnp.int32(1),
                     jnp.int32(0))


@functools.partial(jax.jit, static_argnames="n_rep")
def pipe(S, n, n_rep):
    def body(r, acc):
        pos, cands, lcps = find_matches_device(
            S + dep(acc).astype(jnp.uint8), n, False)
        return (acc + jnp.sum(lcps) + jnp.sum(cands) + jnp.sum(pos))
    return jax.lax.fori_loop(0, n_rep, body, jnp.int32(0))

f1 = lambda: float(pipe(S, n, n_rep=1))
f5 = lambda: float(pipe(S, n, n_rep=5))
t0 = time.time(); f1(); print(f"compile1 {time.time()-t0:.0f}s", flush=True)
f5()
t = time.time(); f1(); t1 = time.time() - t
t = time.time(); f5(); t5 = time.time() - t
per = (t5 - t1) / 4
print(f"match find (argsort): {per*1000:.1f} ms per 1MiB window "
      f"-> {len(data)/per/1e6:.0f} MB/s in-jit", flush=True)

# --- sort-free grouped path: host counting-sort grouping + no-sort
# device kernel (see models/encoder._windows_compact_grouped) ---
from lzfse_rust_tpu.ops.match_find_tpu import (  # noqa: E402
    find_matches_grouped_compact)

tg = []
for _ in range(5):
    t0 = time.time()
    order, ok = native.match_group(src, len(data), False)
    tg.append(time.time() - t0)
t_group = sorted(tg)[1]
P = jnp.asarray(src[None])
NR = jnp.asarray(np.array([len(data)], np.int32))
LO = jnp.asarray(np.zeros(1, np.int32))
HI = jnp.asarray(np.array([len(data) - 3], np.int32))
O = jnp.asarray(order[None])
K8 = jnp.asarray(ok[None])

@functools.partial(jax.jit, static_argnames="n_rep")
def pipe_g(P, NR, LO, HI, O, K8, n_rep):
    def body(r, acc):
        keys, bc, bl, cands, lcps = find_matches_grouped_compact(
            P + dep(acc).astype(jnp.uint8), NR + dep(acc), LO, HI,
            O + dep(acc), K8, False)
        return (acc + jnp.sum(keys.astype(jnp.int32)) + jnp.sum(bc)
                + jnp.sum(bl) + jnp.sum(cands) + jnp.sum(lcps))
    return jax.lax.fori_loop(0, n_rep, body, jnp.int32(0))

g1 = lambda: float(pipe_g(P, NR, LO, HI, O, K8, n_rep=1))
g5 = lambda: float(pipe_g(P, NR, LO, HI, O, K8, n_rep=5))
t0 = time.time(); g1(); print(f"compile grouped {time.time()-t0:.0f}s",
                              flush=True)
g5()
t = time.time(); g1(); t1 = time.time() - t
t = time.time(); g5(); t5 = time.time() - t
per_g = (t5 - t1) / 4
tot = per_g + t_group
print(f"match find (grouped): host group {t_group*1000:.1f} ms + device "
      f"{per_g*1000:.1f} ms per 1MiB window -> {len(data)/tot/1e6:.0f} MB/s "
      f"({len(data)/per_g/1e6:.0f} MB/s device-only in-jit)", flush=True)
