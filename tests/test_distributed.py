"""Multi-process stream sharding: two real processes, one JAX cluster.

Closes SURVEY §2.5's communication-backend row: the reference's only
parallelism is an in-process thread pool (fusion_power_video.cc:1199-1230);
the device build scales across processes by pure data parallelism over a
process-spanning mesh, with jax.distributed + multihost collectives (Gloo
over TCP here).  The test spawns 2 CPU
processes with 4 virtual devices each and byte-/pixel-compares both
directions against the single-process paths.
"""

import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "distributed_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_sharding():
    port = _free_port()
    env = dict(os.environ)
    # each worker pins its own platform/device-count in-process; drop the
    # parent pytest session's settings so they cannot leak a different
    # device count into the workers
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    digests = [
        line.split("sha256=")[1]
        for out in outs
        for line in out.splitlines()
        if line.startswith("WORKER-OK")
    ]
    assert len(digests) == 2 and digests[0] == digests[1], outs
