"""CLI transcoder: convert between the FPV1 and FPVT container profiles.

    fpv-transcode fpvt [shift] [big_endian] < in.fpv  > out.fpvt
    fpv-transcode fpv1                      < in.fpvt > out.fpv

The input profile is auto-detected (FPVT magic vs FPV1 header).  Pixels are
preserved exactly; ``shift``/``big_endian`` only apply to the FPV1 -> FPVT
direction (FPV1 files don't record them — the reference takes them on argv,
encode.cc:41-48 — and the claim is verified against the samples).  FPVT ->
FPV1 carries the header's recorded values over automatically.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 1 or argv[0] not in ("fpv1", "fpvt"):
        sys.stderr.write(
            "Usage: fpv-transcode fpvt|fpv1 [shift] [big_endian]"
            " < infile > outfile\n"
            "    fpvt|fpv1: target profile (input auto-detected)\n"
            "    shift, big_endian: raw-IO contract to stamp on the FPVT\n"
            "      header (FPV1 -> FPVT only; verified against the data)\n"
        )
        return 1
    to_profile = argv[0]
    shift = int(argv[1]) if len(argv) > 1 else 0
    big_endian = bool(int(argv[2])) if len(argv) > 2 else False

    from fpv_tpu.api.transcode import transcode

    data = sys.stdin.buffer.read()
    try:
        out = transcode(data, to_profile, shift=shift, big_endian=big_endian)
    except ValueError as e:
        sys.stderr.write(f"transcode failed: {e}\n")
        return 1
    sys.stdout.buffer.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
