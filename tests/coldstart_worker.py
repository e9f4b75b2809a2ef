"""Worker for the cold-start test: time warmup_stream in a fresh process.

Covers the single-device fused encode/decode programs AND the sharded
whole-file programs (warmup_stream's ``mesh`` parameter) so a serving
process's real startup path is what is measured.
"""

import os
import sys
import time


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ.setdefault("FPV_TPU_RANS_ENGINE", "interpret")
    os.environ.setdefault("FPV_TPU_NARROW_MAX", "0")
    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    from fpv_tpu.api.fpvt_codec import warmup_stream
    from fpv_tpu.parallel.mesh import make_mesh

    warmup_stream(
        64, 64, shift=4, frames_per_batch=4, chunk_log2=6,
        mesh=make_mesh(2, data=2),
    )
    print(f"WARMUP_S {time.time() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
