"""Multi-host scaling-efficiency measurement on the CPU cluster.

The question (BASELINE.md: >=80% efficiency at 2+ hosts): how much does
crossing PROCESS boundaries (the interconnect analog — Gloo collectives
between jax.distributed processes) cost the sharded codec pipeline?

Method — constant-resource strong scaling. Adding CPU "hosts" on one box
cannot add compute; instead the SAME 4 devices are split across
1 / 2 / 4 OS processes (4x1, 2x2, 1x4 devices per host). Total compute and
the global batch stay fixed; the only variable is how many collective hops
cross a process boundary. Efficiency(N) = T(1 host) / T(N hosts). Each
config times the sharded entropy pipeline + the ordered all-gather epilogue
(gather_compressed) over several timed iterations after a barrier'd warmup.
These are CPU-process numbers; they say what process boundaries cost the
sharded program, not what GPUs do.

Run: python tools/bench_scaling.py   (spawns itself per host; ~2 min)
Output: per-config JSON lines + an efficiency table.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

TOTAL_DEVICES = 4
TIMED_ITERS = 8


def worker(proc_id: int, n_hosts: int, port: int, local: int) -> None:
    import jax

    from lzfse_rust_tpu.utils import jax_cache
    jax_cache.enable()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", local)
    if n_hosts > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=n_hosts, process_id=proc_id)
    import numpy as np
    from jax.experimental import multihost_utils

    from __graft_entry__ import _example_arrays
    from lzfse_rust_tpu.parallel.mesh import (gather_compressed, make_mesh,
                                              shard_batch,
                                              sharded_entropy_decode)

    mesh = make_mesh(jax.devices())
    B = n_hosts * local * 4  # 4 blocks per device
    arrays, d = _example_arrays(B)
    n_lit = (d.block.literal.num + 3) // 4
    n_lmd = d.block.lmd.num

    sh = shard_batch(mesh)
    padded = np.tile(np.arange(256, dtype=np.uint8), (B, 1))
    lengths = np.full(B, 200, np.int32)

    def one_iter():
        lit, lmds, ok = sharded_entropy_decode(mesh, arrays, n_lit, n_lmd)
        bg, lg = gather_compressed(mesh, jax.device_put(padded, sh),
                                   jax.device_put(lengths, sh))
        # touch a replicated output so the gather really completes locally
        return int(np.asarray(lg.addressable_data(0))[0]) + int(
            np.asarray(ok.addressable_data(0))[0])

    one_iter()  # warm: compile + first collectives
    if n_hosts > 1:
        multihost_utils.sync_global_devices("scaling-warm")
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        one_iter()
    if n_hosts > 1:
        multihost_utils.sync_global_devices("scaling-done")
    wall = (time.perf_counter() - t0) / TIMED_ITERS

    raw_bytes = B * d.block.n_raw_bytes
    print(json.dumps({
        "host": proc_id, "hosts": n_hosts, "local_devices": local,
        "blocks": B, "iter_wall_s": round(wall, 4),
        "raw_MBps": round(raw_bytes / wall / 1e6, 1),
    }), flush=True)
    if n_hosts > 1:
        jax.distributed.shutdown()


def run_config(n_hosts: int, local: int) -> float:
    port = 13000 + (os.getpid() % 2000) + n_hosts + 17 * local
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), str(n_hosts),
             str(port), str(local)],
            cwd=str(REPO), stdout=subprocess.PIPE, text=True)
        for i in range(n_hosts)
    ]
    walls = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
        for line in out.splitlines():
            if line.startswith("{"):
                walls.append(json.loads(line)["iter_wall_s"])
    return max(walls)  # slowest host bounds the pipeline


def main() -> int:
    # strong scaling at constant resources: the same 4 devices split
    # across 1/2/4 processes (isolates process-boundary collective cost;
    # the 4x1 row also pays 4 full jax runtimes on 4 cores)
    strong = {}
    for n in (1, 2, 4):
        strong[n] = run_config(n, TOTAL_DEVICES // n)
        print(f"strong hosts={n}: {strong[n]*1e3:.1f} ms/iter", flush=True)
    # weak scaling at one device (= one core) per host: per-device work
    # constant, hosts 1/2/4 — flat time = 100% efficiency
    weak = {}
    for n in (1, 2, 4):
        weak[n] = run_config(n, 1)
        print(f"weak   hosts={n}: {weak[n]*1e3:.1f} ms/iter", flush=True)
    print("\nstrong scaling (4 devices total, constant global batch):")
    print("| hosts | devices/host | ms/iter | efficiency |")
    print("|---|---|---|---|")
    for n in (1, 2, 4):
        print(f"| {n} | {TOTAL_DEVICES//n} | {strong[n]*1e3:.1f} "
              f"| {strong[1]/strong[n]*100:.0f}% |")
    print("\nweak scaling (1 device/host, constant per-device batch):")
    print("| hosts | ms/iter | efficiency |")
    print("|---|---|---|")
    for n in (1, 2, 4):
        print(f"| {n} | {weak[n]*1e3:.1f} | {weak[1]/weak[n]*100:.0f}% |")

    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
               int(sys.argv[i + 3]), int(sys.argv[i + 4]))
    else:
        sys.exit(main())
