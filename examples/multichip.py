"""Multi-device scaling: whole FPVT files encoded and decoded data-parallel
over a jax.sharding.Mesh.

Every group of mesh-size batches runs as ONE sharded program
(shard_map over the 'data' axis); the output is byte-identical to the
single-device writer.  On GPUs the mesh spans the cards; on CPU it runs on
virtual devices — start with
XLA_FLAGS=--xla_force_host_platform_device_count=8.
"""

import os

import jax
import numpy as np

# Byte-identity between the sharded and single-device writers holds in the
# fused-kernel regime (the policy both run on a GPU).  To demonstrate it on
# CPU we ask for the same regime: the GPU kernels in the Pallas interpreter
# (slow — so tiny demo shapes below) and full-lane streams (small files
# otherwise take the narrow single-device path by design, see
# FpvtWriter(narrow=...)).
if jax.default_backend() == "cpu":
    os.environ.setdefault("FPV_TPU_RANS_ENGINE", "interpret")
os.environ.setdefault("FPV_TPU_NARROW_MAX", "0")

from fpv_tpu.api.fpvt_codec import encode_file_fpvt
from fpv_tpu.parallel import mesh as pmesh
from fpv_tpu.utils import testdata


def main() -> None:
    ndev = min(len(jax.devices()), 4)
    m = pmesh.make_mesh(ndev, data=ndev)
    print(f"mesh: {ndev} x {jax.devices()[0].platform}")

    # enough frames for two full mesh groups plus a tail.  Tiny frames and
    # chunks keep interpret mode quick on CPU — on real chips use
    # production sizes (1024x1024, frames_per_batch=16, chunk_log2=12)
    n = 1 + 2 * ndev * 2 + 2
    frames = testdata.plasma_frames(n, 16, 16, bits=12, seed=1)

    kw = dict(shift=4, frames_per_batch=2, chunk_log2=4)
    sharded = pmesh.sharded_encode_file(frames, m, **kw)
    single = encode_file_fpvt(frames, **kw)
    assert sharded == single, "sharded writer is byte-identical"

    out = pmesh.sharded_decode_file(sharded, m)
    assert (out == (frames.astype(np.uint16) << 4)).all()
    print(f"{n} frames, {len(sharded)} bytes: sharded encode byte-identical,"
          " sharded decode lossless")


if __name__ == "__main__":
    main()
