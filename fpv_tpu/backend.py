"""The one backend dispatch point: which engine codes FPVT streams.

Every caller that must choose between the device path and the host path
asks :func:`engine`; every device-kernel call site asks :func:`interpret`.

* ``gpu`` — default platform ``gpu``: the fused device programs with the
  compiled GPU kernels (fpv_tpu.ops.rans_triton, ops.predict CG2D).
* ``numpy`` — default platform ``cpu``: the host engine (fpv_tpu.ops.rans_numpy,
  models.predictors) codes every stream and inverts every predictor.
* ``interpret`` — only on request: the fused device programs with the
  kernels run in the Pallas interpreter (CPU tests of the device path).

``FPV_TPU_RANS_ENGINE=numpy|interpret`` asks for an engine explicitly.
Any other platform raises: nothing falls back on its own.
"""

from __future__ import annotations

import os

ENGINE_ENV = "FPV_TPU_RANS_ENGINE"
_PLATFORM_ENGINE = {"gpu": "gpu", "cpu": "numpy"}


def engine() -> str:
    """The engine for this process (see the module docstring)."""
    import jax

    requested = os.environ.get(ENGINE_ENV)
    if requested:
        if requested not in ("numpy", "interpret"):
            raise ValueError(
                f"{ENGINE_ENV}={requested!r}: expected 'numpy' or 'interpret'"
            )
        return requested
    plat = jax.default_backend()
    if plat not in _PLATFORM_ENGINE:
        raise RuntimeError(
            f"unsupported JAX platform {plat!r}: fpv_tpu runs on 'gpu' "
            "(device engine) or 'cpu' (host engine)"
        )
    return _PLATFORM_ENGINE[plat]


def interpret() -> bool:
    """Whether a device kernel runs in the Pallas interpreter: only under
    the ``interpret`` engine.  Otherwise it runs compiled, which needs a
    GPU; reaching a kernel anywhere else raises, it does not fall back."""
    import jax

    if engine() == "interpret":
        return True
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the GPU kernels need a GPU; set "
            f"{ENGINE_ENV}=interpret to run them in the Pallas interpreter"
        )
    return False
