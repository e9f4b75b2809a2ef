"""CLI encoder: raw uint16 frames on stdin -> compressed stream on stdout.

Same argv contract as the reference tool (encode.cc:41-48 — note the
reference's usage string lists ``shift big_endian`` but PARSES
``big_endian shift``; the parse order is the actual contract and is what we
implement):

    fpv-encode xsize ysize big_endian shift [threads] [--profile fpv1|fpvt]

Default profile is fpv1 (byte-compatible with the reference decoder).
"""

from __future__ import annotations

import sys

import numpy as np


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
    if len(argv) < 4:
        sys.stderr.write(
            "Usage: fpv-encode xsize ysize big_endian shift [threads]"
            " [--profile fpv1|fpvt] < infile > outfile\n"
            "    xsize, ysize: frame size in pixels\n"
            "    big_endian: endianness of the raw input data, 0 or 1\n"
            "    shift: bits to shift left so MSBs are used (12-bit data: 4)\n"
        )
        return 1
    xsize, ysize, big_endian, shift = (int(a) for a in argv[:4])
    num_threads = int(argv[4]) if len(argv) > 4 else 4
    if not (0 < xsize <= 65536 and 0 < ysize <= 65536):
        sys.stderr.write(f"invalid xsize, ysize: {xsize} {ysize}\n")
        return 1
    if shift > 16:
        sys.stderr.write(f"invalid shift: {shift}\n")
        return 1

    framesize = xsize * ysize * 2
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer

    def read_frame() -> np.ndarray | None:
        buf = stdin.read(framesize)
        if len(buf) < framesize:
            return None
        return np.frombuffer(buf, dtype="<u2").reshape(ysize, xsize)

    if profile == "fpvt":
        from fpv_tpu.api.fpvt_codec import FpvtWriter

        # narrow=False: a pipe's total length is unknown, so the
        # small-FILE state-saving policy can't apply — and a long pipe of
        # mid-size frames must not pay host coding per batch (the hubs
        # make the same call; one-shot small files go through
        # encode_file_fpvt, which sizes the policy from the total)
        writer = FpvtWriter(
            xsize, ysize, shift=shift, big_endian=bool(big_endian),
            delta_is_frame0=True, narrow=False,
        )
        batch: list[np.ndarray] = []
        initialized = False
        while (img := read_frame()) is not None:
            if not initialized:
                # first frame IS the delta frame (HDR_F_DELTA_IS_FRAME0):
                # stored once; the decoder synthesizes it as frame 0
                stdout.write(writer.init(img))
                initialized = True
                continue
            batch.append(img)
            if len(batch) == writer.header.frames_per_batch:
                stdout.write(writer.encode_batch(np.stack(batch)))
                batch.clear()
        if batch:
            stdout.write(writer.encode_batch(np.stack(batch)))
        if initialized:
            stdout.write(writer.finish())
        return 0

    from fpv_tpu.api.encoder import Encoder

    enc = Encoder(num_threads=num_threads, shift=shift, big_endian=bool(big_endian))
    write_cb = lambda data, _payload: stdout.write(data)
    initialized = False
    while (img := read_frame()) is not None:
        if not initialized:
            enc.init(img, xsize, ysize, write_cb)
            initialized = True
        enc.compress_frame(img, write_cb)
    enc.finish(write_cb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
