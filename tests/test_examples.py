"""The examples/ scripts must stay runnable (they are documentation)."""

import os
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.parametrize(
    "script", ["fpv1_compat.py", "fpvt_pipeline.py", "serving_hubs.py",
               "multichip.py", "ctx_study.py --fast",
               "temporal_study.py --fast",
               "large_frame_study.py --fast --reps 1 --chunks 9,10"]
)
def test_example_runs(script):
    script, *extra = script.split()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    p = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *extra],
        capture_output=True, cwd=REPO, env=env, timeout=900,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]
