"""Test configuration: an 8-device virtual CPU mesh before JAX loads.

Multi-device sharding is tested on the CPU by emulating devices
(xla_force_host_platform_device_count).  Tests that only a GPU can run
carry the ``gpu`` marker and the ``gpu`` fixture, which skips them unless
the process runs on a GPU: run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if (os.environ["JAX_PLATFORMS"] == "cpu"
        and "xla_force_host_platform_device_count" not in flags):
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

import pathlib
import subprocess

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REFBIN = REPO / ".refbin"
REFERENCE_SRC = pathlib.Path("/root/reference")

# build fpv_native once per fresh host so the native-path tests run against
# the extension rather than silently exercising only the ctypes fallback
from fpv_tpu.utils.nativebuild import ensure_native_built  # noqa: E402

ensure_native_built()


def _build_reference() -> bool:
    """Compile the reference binaries (one-time) for interop tests."""
    if not REFERENCE_SRC.exists():
        return False
    REFBIN.mkdir(exist_ok=True)
    for tool in ("encode", "decode", "benchmark"):
        out = REFBIN / f"ref_{tool}"
        if out.exists():
            continue
        cmd = (
            f"g++ -O3 -std=c++14 -I{REPO}/native/brotli_shim "
            f"{REFERENCE_SRC}/fusion_power_video.cc {REFERENCE_SRC}/{tool}.cc "
            "-l:libbrotlienc.so.1 -l:libbrotlidec.so.1 -l:libbrotlicommon.so.1 "
            f"-lpthread -o {out}"
        )
        try:
            subprocess.run(cmd, shell=True, check=True, capture_output=True,
                           timeout=300)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
            return False
    return True


def have_reference() -> bool:
    if (REFBIN / "ref_encode").exists():
        return True
    return _build_reference()


def ref_encode(raw: bytes, xsize: int, ysize: int, big_endian: int, shift: int,
               threads: int = 2) -> bytes:
    """Run the compiled reference encoder on raw frame bytes."""
    proc = subprocess.run(
        [str(REFBIN / "ref_encode"), str(xsize), str(ysize), str(big_endian),
         str(shift), str(threads)],
        input=raw, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, check=True,
    )
    return proc.stdout


def ref_decode(data: bytes, xsize: int, ysize: int, big_endian: int, shift: int) -> bytes:
    """Run the compiled reference decoder -> raw frame bytes."""
    proc = subprocess.run(
        [str(REFBIN / "ref_decode"), str(xsize), str(ysize), str(big_endian),
         str(shift)],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, check=True,
    )
    return proc.stdout


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skipped elsewhere"
    )


@pytest.fixture
def gpu():
    """Skip unless this process runs on a GPU (decided here, at test time,
    never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda on the card")
    return jax.devices()[0]


requires_reference = pytest.mark.skipif(
    not have_reference(), reason="reference binaries not built (.refbin)"
)
