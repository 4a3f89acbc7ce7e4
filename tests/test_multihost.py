"""Multi-host distributed backend test.

Spawns TWO separate processes that join a ``jax.distributed`` group over
localhost (the DCN-style process-group path of ``multihost_init``), render a
row-sharded frame over the global 2x4-device CPU mesh, and assert bitwise
parity against a single-device render.  This exercises exactly the machinery
a 2-host deployment uses — process coordination, global meshes,
non-addressable arrays — with XLA's CPU collectives standing in for the
interconnect.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_row_sharded_parity():
    port = _free_port()
    env = os.environ.copy()
    # the children run on the CPU platform with 4 virtual devices each
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen([sys.executable, WORKER, str(port), str(i)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        assert f"rank {i} OK" in out, f"rank {i} output:\n{out[-3000:]}"
        assert f"rank {i} wave OK" in out, f"rank {i} output:\n{out[-3000:]}"
        assert f"rank {i} scaling mechanism OK" in out, out[-3000:]
