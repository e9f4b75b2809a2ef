"""The backend dispatch point, compile-cache placement, device counts."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from fpv_tpu import backend

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "platform,requested,engine,interpreted",
    [
        ("gpu", None, "gpu", False),
        ("cpu", None, "numpy", None),  # None: a kernel here raises
        ("cpu", "interpret", "interpret", True),
        ("gpu", "numpy", "numpy", False),
    ],
)
def test_dispatch(monkeypatch, platform, requested, engine, interpreted):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if requested:
        monkeypatch.setenv(backend.ENGINE_ENV, requested)
    else:
        monkeypatch.delenv(backend.ENGINE_ENV, raising=False)
    assert backend.engine() == engine
    if interpreted is None:
        with pytest.raises(RuntimeError, match="interpret"):
            backend.interpret()
    else:
        assert backend.interpret() == interpreted


@pytest.mark.parametrize(
    "platform,requested,error",
    [("metal", None, RuntimeError), ("rocm", None, RuntimeError),
     ("cpu", "pallas", ValueError)],
)
def test_dispatch_refuses(monkeypatch, platform, requested, error):
    """Other platforms and unknown engine names raise; nothing falls back."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if requested:
        monkeypatch.setenv(backend.ENGINE_ENV, requested)
    else:
        monkeypatch.delenv(backend.ENGINE_ENV, raising=False)
    with pytest.raises(error):
        backend.engine()


def _cache_dir(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run(
        [sys.executable, "-c",
         "import fpv_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=300, cwd="/", env=env,
    )
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_compile_cache_env_honoured(tmp_path):
    assert _cache_dir(str(tmp_path / "cc")) == str(tmp_path / "cc")


def test_compile_cache_default_in_checkout():
    import fpv_tpu

    assert _cache_dir(None) == str(REPO / ".jax_cache")
    assert fpv_tpu.JIT_CACHE_DIR == REPO / ".jax_cache"


def test_multichip_dryrun_needs_devices():
    from fpv_tpu.parallel.mesh import multichip_dryrun

    with pytest.raises(RuntimeError, match="needs"):
        multichip_dryrun(len(jax.devices()) + 1)


def test_cg2d_decode_dispatch(monkeypatch):
    """cg2d_decode: the host numpy wavefront on a CPU, the kernel in the
    interpreter only when asked; both invert cg2d_encode."""
    from fpv_tpu.ops import predict

    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, (2, 19, 23), np.int64).astype(np.uint8)
    res = predict.cg2d_encode(plane)
    monkeypatch.delenv(backend.ENGINE_ENV, raising=False)
    host = np.asarray(jax.jit(predict.cg2d_decode)(res))
    monkeypatch.setenv(backend.ENGINE_ENV, "interpret")
    interp = np.asarray(predict.cg2d_decode(res))
    np.testing.assert_array_equal(host, plane)
    np.testing.assert_array_equal(interp, plane)
