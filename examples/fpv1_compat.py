"""FPV1 compatibility profile: the reference's file format, byte-exact.

Files written here are byte-identical to the reference C++ encoder's
(/root/reference/fusion_power_video.cc) and decode with either side.
"""

import numpy as np

import fpv_tpu
from fpv_tpu.api.decoder import RandomAccessDecoder, StreamingDecoder
from fpv_tpu.api.frame import unextract_frame
from fpv_tpu.utils import testdata


def main() -> None:
    # 12-bit sensor data, left-aligned by shift=4 inside the codec
    frames = testdata.plasma_frames(8, 128, 160, bits=12)
    raw = testdata.to_raw_bytes(frames)  # little-endian u16 capture
    imgs = np.frombuffer(raw, dtype="<u2").reshape(8, 128, 160)

    data = fpv_tpu.encode_file(imgs, shift=4, num_threads=2)
    print(f"FPV1: {len(raw)} raw -> {len(data)} bytes "
          f"({8 * len(data) / imgs.size:.3f} bpp)")

    # library decode returns LEFT-ALIGNED frames (reference DecodeFrame
    # semantics); unextract_frame restores the original raw values
    out = fpv_tpu.decode_file(data)
    rest = np.stack(
        [unextract_frame(f, shift=4, big_endian=False) for f in out]
    )
    assert rest.tobytes() == raw, "lossless roundtrip"

    # streaming decode with arbitrary chunking
    got = []
    dec = StreamingDecoder()
    for i in range(0, len(data), 64 * 1024):
        dec.decode(
            data[i : i + 64 * 1024],
            lambda ok, img, x, y, payload: got.append(img),
        )
    assert len(got) == 8

    # random access + 1/4-scale preview
    r = RandomAccessDecoder()
    assert r.init(data)
    frame3 = r.decode_frame(3)
    preview3 = r.decode_preview(3)
    print(f"random access: frame {frame3.shape}, preview {preview3.shape}")

    # migrate the archive to the FPVT device container (and back) without
    # re-running the capture pipeline — pixels preserved exactly
    fpvt_data = fpv_tpu.transcode_to_fpvt(data, shift=4)
    back = fpv_tpu.transcode_to_fpv1(fpvt_data)
    assert np.array_equal(fpv_tpu.decode_file(back), out)
    print(f"transcode: FPV1 {len(data)} B -> FPVT {len(fpvt_data)} B -> "
          f"FPV1 {len(back)} B, lossless")
    print("ok")


if __name__ == "__main__":
    main()
