"""CLI benchmark + roundtrip verifier, mirroring the reference harness.

Argv contract (benchmark.cc:288-327, parse order):

    fpv-benchmark filename xsize ysize big_endian shift [maxframes] [threads]
                  [--profile fpv1|fpvt]

Encodes the raw capture (timed), then verifies byte-exact roundtrip through
both decode paths, then prints per-frame and total statistics to stderr like
PrintBenchmark (benchmark.cc:68-85).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def print_benchmark(label, pixels, size, t=0.0, numframes=0):
    msg = f"{label}: {size} bytes"
    if pixels:
        msg += f", {size / pixels * 8:.4g} bpp"
    if numframes > 1:
        msg += f", bytes per frame: {size / numframes:.6g}"
    if t > 0:
        msg += (
            f", time: {t*1000:.4g} ms, speed: {pixels/t/1e6:.4g} MP/s"
            f", frames per second: {numframes/t:.4g}"
        )
    sys.stderr.write(msg + "\n")


def render_preview(preview: np.ndarray) -> None:
    """ASCII-art preview renderer (benchmark.cc:87-103)."""
    chars = [(16, " "), (24, "."), (32, ","), (48, ":"), (64, ";"),
             (128, "+"), (192, "=")]
    for y in range(0, preview.shape[0], 4):
        line = []
        for x in range(0, preview.shape[1], 4):
            v = int(preview[y, x])
            for lim, ch in chars:
                if v < lim:
                    line.append(ch)
                    break
            else:
                line.append("#")
        sys.stderr.write("".join(line) + "\n")
    sys.stderr.write("\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    profile = "fpv1"
    if "--profile" in argv:
        i = argv.index("--profile")
        if i + 1 >= len(argv):
            argv = []  # trailing --profile without a value: show usage
        else:
            profile = argv[i + 1]
            del argv[i : i + 2]
    if len(argv) < 5:
        sys.stderr.write(
            "Usage: fpv-benchmark filename xsize ysize big_endian shift"
            " [maxframes] [threads] [--profile fpv1|fpvt]\n"
        )
        return 1
    filename = argv[0]
    xsize, ysize, big_endian, shift = (int(a) for a in argv[1:5])
    maxframes = int(argv[5]) if len(argv) > 5 else 0
    threads = int(argv[6]) if len(argv) > 6 else 4

    framesize = xsize * ysize * 2
    with open(filename, "rb") as f:
        raw = f.read(maxframes * framesize if maxframes else -1)
    num = len(raw) // framesize
    if num * framesize != len(raw):
        sys.stderr.write("raw filesize is not a multiple of framesize\n")
    raw = raw[: num * framesize]
    frames = np.frombuffer(raw, dtype="<u2").reshape(num, ysize, xsize)
    numpixels = xsize * ysize
    total_pixels = num * numpixels

    from fpv_tpu.api.frame import unextract_frame

    if profile == "fpvt":
        from fpv_tpu.api.fpvt_codec import FpvtReader, FpvtWriter

        t0 = time.time()
        w = FpvtWriter(xsize, ysize, shift=shift, big_endian=bool(big_endian))
        parts = [w.init(frames[0])]
        fpb = w.header.frames_per_batch
        for s in range(0, num, fpb):
            parts.append(w.encode_batch(frames[s : s + fpb]))
        parts.append(w.finish())
        data = b"".join(parts)
        t = time.time() - t0
        print_benchmark("total", total_pixels, len(data), t, num)

        sys.stderr.write("verifying random access decoder...\n")
        r = FpvtReader(data)
        assert r.numframes == num
        idx = 0
        for bi in range(r.num_batches):
            imgs = r.decode_batch(bi)
            for i in range(imgs.shape[0]):
                after = unextract_frame(imgs[i], shift, bool(big_endian)).tobytes()
                if after != raw[idx * framesize : (idx + 1) * framesize]:
                    sys.stderr.write(f"Error: roundtrip not equal! {idx}\n")
                    return 1
                idx += 1
        sys.stderr.write("ok\n")
        return 0

    from fpv_tpu.api.decoder import RandomAccessDecoder, StreamingDecoder
    from fpv_tpu.api.encoder import Encoder

    chunks: list[bytes] = []
    sizes: list[int] = []

    def frame_cb(data: bytes, payload):
        chunks.append(data)
        print_benchmark(f"frame {payload}", numpixels, len(data))

    t0 = time.time()
    enc = Encoder(num_threads=threads, shift=shift, big_endian=bool(big_endian))
    enc.init(frames[0], xsize, ysize,
             lambda d, _p: (chunks.append(d),
                            print_benchmark("header", 0, len(d))))
    for i in range(num):
        enc.compress_frame(frames[i], frame_cb, i)
    enc.finish(lambda d, _p: (chunks.append(d),
                              print_benchmark("footer", 0, len(d))))
    total_time = time.time() - t0
    compressed = b"".join(chunks)
    print_benchmark("total", total_pixels, len(compressed), total_time, num)

    sys.stderr.write("verifying streaming decoder...\n")
    sdec = StreamingDecoder()
    decoded = 0

    def verify_cb(ok, image, xs, ys, _p):
        nonlocal decoded
        if not ok:
            sys.stderr.write("StreamingDecoder decode failed\n")
            raise SystemExit(1)
        after = unextract_frame(image, shift, bool(big_endian)).tobytes()
        if after != raw[decoded * framesize : (decoded + 1) * framesize]:
            sys.stderr.write(f"Error: roundtrip not equal! {decoded}\n")
            raise SystemExit(1)
        decoded += 1

    for pos in range(0, len(compressed), 65536):
        sdec.decode(compressed[pos : pos + 65536], verify_cb)
    if decoded != num:
        sys.stderr.write(f"Error: not all frames decoded: {decoded} / {num}\n")
        return 1
    sys.stderr.write("ok\nverifying random access decoder...\n")

    rdec = RandomAccessDecoder()
    if not rdec.init(compressed):
        sys.stderr.write("RandomAccessDecoder::Init failed\n")
        return 1
    if rdec.numframes != num or rdec.xsize != xsize or rdec.ysize != ysize:
        sys.stderr.write("RandomAccessDecoder::Init mismatch\n")
        return 1
    for i in range(num):
        image = rdec.decode_frame(i)
        rdec.decode_preview(i)
        after = unextract_frame(image, shift, bool(big_endian)).tobytes()
        if after != raw[i * framesize : (i + 1) * framesize]:
            sys.stderr.write(f"Error: roundtrip not equal! {i}\n")
            return 1
    sys.stderr.write("ok\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
