"""Multi-HOST sharded codec demonstration (beyond the single-process mesh).

The reference is single-threaded (SURVEY.md §2.3); our scale-out design is
data-parallel block sharding over a device mesh with XLA collectives. The
in-suite validation runs one process with a virtual 8-device mesh; THIS
script validates the same sharded pipeline across a real process boundary:

  - N OS processes ("hosts", default 2) each own 4 CPU devices and join a
    jax.distributed cluster (coordinator + Gloo collectives — the CPU
    stand-in for a real interconnect; on GPU hosts the identical code runs
    over NCCL because the mesh/sharding annotations are the program).
  - A global (N*4)-device mesh shards the block batch; every host decodes
    only its addressable shard (jax.device_put materializes just the local
    blocks of the global array).
  - The ordered all-gather epilogue (parallel/mesh.py gather_compressed)
    crosses the process boundary for real, and every host receives the
    full gathered result.
  - Host 0 cross-checks the decoded bytes against the scalar spec oracle.

Run: python tools/demo_multihost.py [--hosts 2]
(Spawns itself; exits 0 on success, prints one JSON line per host.)
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

LOCAL_DEVICES = 4


def worker(proc_id: int, n_hosts: int, port: int) -> None:
    import jax

    from lzfse_rust_tpu.utils import jax_cache
    jax_cache.enable()
    # the platform switch must precede backend init
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_hosts,
        process_id=proc_id,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from __graft_entry__ import _example_arrays, fixture
    from lzfse_rust_tpu.parallel.mesh import (gather_compressed, make_mesh,
                                              sharded_entropy_decode,
                                              sharded_rebuild)
    from lzfse_rust_tpu.spec import container as spec

    n_dev = n_hosts * LOCAL_DEVICES
    devices = jax.devices()
    assert len(devices) == n_dev, (proc_id, len(devices))
    mesh = make_mesh(devices)

    B = n_dev * 2  # two blocks per device
    arrays, d = _example_arrays(B)

    t0 = time.perf_counter()
    literals, lmds, ok = sharded_entropy_decode(
        mesh, arrays, n_lit_steps=(d.block.literal.num + 3) // 4,
        n_lmd_steps=d.block.lmd.num)
    ok_all = multihost_utils.process_allgather(ok, tiled=True)
    assert np.asarray(ok_all).all(), "invalid blocks flagged"
    t_entropy = time.perf_counter() - t0

    # container-parallel rebuild on the gathered host rows (each host
    # rebuilds its shard; results gathered for the oracle check)
    nl = d.block.lmd.num
    rows = np.asarray(multihost_utils.process_allgather(lmds,
                                                        tiled=True))[:, :nl]
    lit_np = np.asarray(multihost_utils.process_allgather(literals,
                                                          tiled=True))
    consumed = int(rows[0, :, 0].sum())
    out, rok = sharded_rebuild(
        mesh, lit_np[:, :max(consumed, 1)], rows,
        np.full(B, d.block.n_raw_bytes, np.int32),
        n_out=(d.block.n_raw_bytes + 4095) // 4096 * 4096)
    rok_all = multihost_utils.process_allgather(rok, tiled=True)
    assert np.asarray(rok_all).all(), "invalid containers flagged"

    # the encode-side collective: ordered all-gather of padded compressed
    # blocks + true lengths ACROSS THE PROCESS BOUNDARY
    padded = np.tile(np.arange(256, dtype=np.uint8), (B, 1))
    padded[:, 0] = np.arange(B, dtype=np.uint8)
    lengths = np.arange(B, dtype=np.int32) + 7
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("blocks"))
    blocks_g, lens_g = gather_compressed(
        mesh, jax.device_put(padded, sh), jax.device_put(lengths, sh))
    # out_specs=P() makes the gather fully replicated; every host must see
    # every block's true length in order in its local replica
    lens_np = np.asarray(lens_g.addressable_data(0))
    assert np.array_equal(lens_np, np.arange(B, dtype=np.int32) + 7), lens_np
    blk_np = np.asarray(blocks_g.addressable_data(0))
    assert np.array_equal(blk_np[:, 0], np.arange(B, dtype=np.uint8))

    # oracle check on host 0
    out_all = np.asarray(multihost_utils.process_allgather(out, tiled=True))
    if proc_id == 0:
        want = spec.decode_bytes(fixture())
        for b in range(B):
            got = out_all[b, :d.block.n_raw_bytes].tobytes()
            assert got == want, f"block {b} mismatch vs spec oracle"

    print(json.dumps({
        "host": proc_id, "hosts": n_hosts, "devices": n_dev,
        "blocks": B, "entropy_wall_s": round(t_entropy, 3), "ok": True,
    }), flush=True)
    jax.distributed.shutdown()


def main() -> int:
    n_hosts = 2
    args = sys.argv[1:]
    if "--hosts" in args:
        n_hosts = int(args[args.index("--hosts") + 1])
    port = 12000 + (os.getpid() % 2000)
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), str(n_hosts),
             str(port)],
            cwd=str(REPO))
        for i in range(n_hosts)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
               int(sys.argv[i + 3]))
    else:
        sys.exit(main())
