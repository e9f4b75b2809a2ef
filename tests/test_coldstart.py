"""Serving cold-start: the persistent compilation cache must actually work.

A fresh process with a WARM cache has to start serving much faster than the
first process that populated it — otherwise warmup_stream +
fpv_tpu._enable_jit_cache are decoration, not a cold-start story.  Two real
subprocesses share one cache directory; the second must be substantially
faster and the cache directory must contain the compiled executables.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "coldstart_worker.py"


def _run(env) -> float:
    p = subprocess.run(
        [sys.executable, str(WORKER)], capture_output=True, text=True,
        timeout=600, cwd=REPO, env=env,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    for line in p.stdout.splitlines():
        if line.startswith("WARMUP_S"):
            return float(line.split()[1])
    raise AssertionError(f"no WARMUP_S line:\n{p.stdout}\n{p.stderr}")


def test_warm_cache_speeds_up_fresh_process(tmp_path):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jit_cache")
    cold = _run(env)
    entries = list((tmp_path / "jit_cache").iterdir())
    assert entries, "persistent cache wrote nothing"
    warm = _run(env)
    # the warm process skips XLA compilation entirely; tracing and small
    # un-cached programs remain, so require a robust (not razor-thin) win
    assert warm < cold * 0.75, (cold, warm)
