"""Multi-process (multi-"host") sharded codec regression.

Spawns tools/demo_multihost.py: 2 OS processes x 4 CPU devices join a
jax.distributed cluster, shard the block batch over the global 8-device
mesh, decode, and run the ordered all-gather epilogue across the process
boundary (Gloo — the CPU stand-in for the interconnect). The demo itself asserts
bit-exactness against the spec oracle on host 0.

This is the closest single-box analog of the reference's two-process pipe
test (the reference's test/src/huge.rs:27-43): correctness across real
process boundaries, here with actual cross-process collectives.
"""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_two_host_sharded_codec():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "demo_multihost.py"),
         "--hosts", "2"],
        capture_output=True, text=True, timeout=280, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(l) for l in proc.stdout.splitlines()
            if l.startswith("{")]
    assert len(rows) == 2
    assert all(r["ok"] and r["devices"] == 8 for r in rows)
