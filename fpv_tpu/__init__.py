"""fpv_tpu — lossless 16-bit grayscale video compression on an accelerator.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
google/fusion-power-video: byte-plane splitting, delta-frame and
clamped-gradient prediction, entropy coding, a self-describing container with
random-access frame index and embedded previews, streaming encode/decode
sessions, a columnar batch subsystem and an Arrow frontend — plus a batched
container profile (FPVT) whose entire data path (filter chain and chunked
rANS entropy coding) runs on the device.
"""

__version__ = "0.1.0"

import os as _os
import pathlib as _pathlib

# JAX's persistent compilation cache: where JAX_COMPILATION_CACHE_DIR says,
# otherwise one fixed directory inside the checkout (the path is part of
# the cache key, so it must not move between runs)
JIT_CACHE_DIR = _pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def _enable_jit_cache() -> None:
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):  # else JAX reads it
        jax.config.update("jax_compilation_cache_dir", str(JIT_CACHE_DIR))


_enable_jit_cache()

from fpv_tpu.api.frame import ChunkFlags, FrameFlags, FramePlanes  # noqa: F401
from fpv_tpu.api.encoder import Encoder, encode_file  # noqa: F401
from fpv_tpu.api.decoder import (  # noqa: F401
    RandomAccessDecoder,
    StreamingDecoder,
    decode_file,
)

# FPVT-profile and serving names resolve lazily (PEP 562): they pull in the
# device codec stack, which FPV1-only users shouldn't pay import time for
_LAZY = {
    "encode_file_fpvt": "fpv_tpu.api.fpvt_codec",
    "decode_file_fpvt": "fpv_tpu.api.fpvt_codec",
    "FpvtReader": "fpv_tpu.api.fpvt_codec",
    "FpvtWriter": "fpv_tpu.api.fpvt_codec",
    "FpvtStreamingReader": "fpv_tpu.api.fpvt_codec",
    "warmup_stream": "fpv_tpu.api.fpvt_codec",
    "MultiStreamEncoder": "fpv_tpu.api.multistream",
    "MultiStreamDecoder": "fpv_tpu.api.multistream",
    "transcode": "fpv_tpu.api.transcode",
    "transcode_to_fpvt": "fpv_tpu.api.transcode",
    "transcode_to_fpv1": "fpv_tpu.api.transcode",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'fpv_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
