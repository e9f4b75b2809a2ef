"""FPVT (device) profile: batched device codec, timestamps, previews,
frame-granular random access, and byte accounting.

On a GPU the whole batch encodes as ONE fused jit program (model step,
table building, rANS kernels); on CPU the same format is produced
by the vectorized numpy engine.
"""

import numpy as np

from fpv_tpu.api.fpvt_codec import (
    FpvtReader,
    decode_file_fpvt,
    encode_file_fpvt,
)
from fpv_tpu.cli.inspect import format_report, inspect_bytes
from fpv_tpu.utils import testdata


def main() -> None:
    frames = testdata.plasma_frames(16, 128, 160, bits=12, seed=3)
    ts = 1_000_000 + 40_000 * np.arange(16, dtype=np.int64)  # 25 kfps

    data = encode_file_fpvt(
        frames, shift=4, frames_per_batch=8, timestamps=ts
    )
    print(f"FPVT: {8 * len(data) / frames.size:.3f} bpp")

    # lossless roundtrip (left-aligned values, like the reference library)
    out = decode_file_fpvt(data)
    assert (out == (frames.astype(np.uint16) << 4)).all()

    r = FpvtReader(data)
    # one frame decodes from only its covering rANS blocks
    f5 = r.decode_frame(5)
    pv5 = r.preview_frame(5)
    print(f"frame 5: {f5.shape} u16, preview {pv5.shape} u8")
    # timestamps ride in the batch sections (frame 0 doubles as the
    # delta frame, so its section starts at frame 1)
    print("timestamps batch 0:", r.timestamps(0))

    # where every byte goes (tables / states / counts / payload)
    print(format_report(inspect_bytes(data)))


if __name__ == "__main__":
    main()
