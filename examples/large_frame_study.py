"""Large-frame (4096x4096) chunk-length A/B study.

Asks whether large-frame decode speed depends on the chunk geometry (block
count, per-step word group size) or is intrinsic to the big-payload path:

* chunk_log2 in {11, 12, 13} re-encodes the SAME frames (the wire format
  carries chunk_log2 in the header, fpv_tpu/format/fpvt.py:91, so each
  variant is a valid file, not a fork), then times the fused device decode
  round-robin interleaved.
* Each variant also reports encode time, whole-file size, and a
  previews-off decode time so the 1/16-scale preview pass at this
  geometry (1024x1024 per frame) is priced separately.

Geometry maps (B=4, 4096^2, per plane): chunk 2^11 -> 32 blocks,
2^12 -> 16, 2^13 -> 8 kernel programs per plane, so this directly varies
the device parallelism while total symbols stay fixed.

Usage: python examples/large_frame_study.py [--fast] [--reps N]
--fast runs 256x256 x2 frames for a smoke run (geometry labels shift
accordingly; on CPU the kernels run in the Pallas interpreter); results
are meaningful only at full size on a GPU.

The reference's single-threaded per-pixel loop has no geometry
sensitivity at all (fusion_power_video.cc:296-347).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def run(size: int, frames: int, chunks: list[int], reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    if jax.default_backend() == "cpu":
        os.environ.setdefault("FPV_TPU_RANS_ENGINE", "interpret")

    from fpv_tpu.api.fpvt_codec import (
        FpvtReader,
        FpvtWriter,
        batch_decode_args,
        fused_decode_batch,
        fused_encode_batch,
    )
    from fpv_tpu.utils import testdata

    H = W = size
    B = frames
    SHIFT = 4
    base = testdata.plasma_frames(1, H, W, bits=12, seed=11)[0]
    all_frames = np.stack(
        [np.roll(base, (3 * i, 5 * i), (0, 1)) for i in range(B + 1)]
    )
    want = all_frames[1:].astype(np.uint16) << SHIFT

    res: dict = {"b": B, "h": H, "w": W, "chunk_log2s": chunks}
    variants = []  # (label, dec_fn, dec_nopv_fn)
    for cl in chunks:
        # narrow=False: the study targets the wide fused-device regime at
        # every chunk size (the --fast smoke would otherwise fall into the
        # narrow/host-coded small-batch policy)
        w = FpvtWriter(W, H, shift=SHIFT, frames_per_batch=B, chunk_log2=cl,
                       narrow=False)
        data = w.init(all_frames[0])
        data += w.encode_batch(all_frames[1:])
        data += w.finish()
        res[f"cl{cl}_file_bytes"] = len(data)
        res[f"cl{cl}_bpp"] = 8.0 * len(data) / (B * H * W * 2)

        # device-resident encode timing (same methodology as bench.py)
        chunk_len = 1 << cl
        imgs_dev = jax.block_until_ready(jnp.asarray(all_frames[1:]))

        @jax.jit
        def _enc(im, _w=w, _k=chunk_len):
            out = fused_encode_batch(
                im, _w._delta_high, _w._delta_low, SHIFT, False, _k,
                low_coding=_w._low_coding, allow_prev=True,
            )
            return sum(jnp.sum(x.astype(jnp.uint32)) for x in out)

        np.asarray(_enc(imgs_dev))
        ts = []
        for _ in range(reps):
            t0 = time.time()
            np.asarray(_enc(imgs_dev))
            ts.append(time.time() - t0)
        res[f"cl{cl}_enc_mpix_s"] = B * H * W / 1e6 / min(ts)

        rdr = FpvtReader(data)
        pb = rdr._parse_batch(rdr._batches[0][0])
        arrays, static = batch_decode_args(pb, chunk_len)
        args = (
            jnp.asarray(arrays["payload"]), jnp.asarray(arrays["plane_offs"]),
            jnp.asarray(arrays["counts"]), jnp.asarray(arrays["states"]),
            jnp.asarray(arrays["flags"]), jnp.asarray(arrays["tables"]),
            rdr._delta_high, rdr._delta_low,
            jnp.asarray(arrays["const_vals"]),
        )
        jax.block_until_ready(args)

        def _dec(pv, _args=args, _k=chunk_len, _static=static):
            out = fused_decode_batch(
                *_args, chunk_len=_k, b=B, h=H, w=W, decode_preview=pv,
                **_static,
            )
            return out[0], out[1]

        imgs, ok = _dec(True)
        assert bool(np.asarray(ok)), f"chunk_log2={cl} integrity failed"
        assert (np.asarray(imgs) == want).all(), f"chunk_log2={cl} mismatch"
        del imgs
        np.asarray(_dec(False)[1])  # warm the previews-off program too
        variants.append((cl, _dec))
        del imgs_dev

    # round-robin interleaved decode timing: previews-on and previews-off
    # as separate interleaved passes
    for label, pv in (("dec", True), ("dec_nopv", False)):
        best = {cl: float("inf") for cl, _ in variants}
        for _ in range(reps):
            for cl, fn in variants:
                t0 = time.time()
                np.asarray(fn(pv)[1])
                best[cl] = min(best[cl], time.time() - t0)
        for cl, t in best.items():
            res[f"cl{cl}_{label}_mpix_s"] = B * H * W / 1e6 / t
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="256^2 x2 frames smoke (CI)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", type=str, default="11,12,13")
    args = ap.parse_args()
    size, frames = (256, 2) if args.fast else (4096, 4)
    chunks = [int(c) for c in args.chunks.split(",")]
    rep = run(size, frames, chunks, reps=args.reps)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
