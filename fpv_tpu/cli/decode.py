"""CLI decoder: compressed stream on stdin -> raw uint16 frames on stdout.

Argv contract matches the reference's parse order (decode.cc:41-44):

    fpv-decode xsize ysize big_endian shift < infile > outfile

Auto-detects the profile (FPVT magic vs FPV1 header) from the first bytes.
Reads stdin in 1 MiB blocks like the reference (decode.cc:67-77).
"""

from __future__ import annotations

import sys



def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 4:
        sys.stderr.write(
            "Usage: fpv-decode xsize ysize big_endian shift < infile > outfile\n"
        )
        return 1
    xsize, ysize, big_endian, shift = (int(a) for a in argv)
    if not (0 < xsize <= 65536 and 0 < ysize <= 65536):
        sys.stderr.write(f"invalid xsize, ysize: {xsize} {ysize}\n")
        return 1
    if shift > 16:
        sys.stderr.write(f"invalid shift: {shift}\n")
        return 1

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    head = stdin.read(4)
    count = 0

    if head == b"FPVT":
        # FPVT profile: batch-oriented; read whole stream (random access
        # format), decode batch by batch on device — two batches in flight
        # (decode_file_fpvt's pipeline) so batch n's output writes while
        # batch n+1 decodes.
        from concurrent.futures import ThreadPoolExecutor

        data = head + stdin.read()
        from fpv_tpu.api.fpvt_codec import FpvtReader
        from fpv_tpu.api.frame import unextract_frame

        r = FpvtReader(data)
        if r.header.delta_is_frame0:
            stdout.write(
                unextract_frame(
                    r.frame0(), shift, bool(big_endian)
                ).tobytes()
            )
            sys.stderr.write(f"extracted frame {count}\n")
            count += 1
        with ThreadPoolExecutor(max_workers=1) as pool:
            nxt = (
                pool.submit(r.decode_batch, 0) if r.num_batches else None
            )
            for bi in range(r.num_batches):
                imgs = nxt.result()
                # bound in-flight batches at one ahead: a blocked stdout
                # pipe must apply backpressure, not grow the heap
                nxt = (
                    pool.submit(r.decode_batch, bi + 1)
                    if bi + 1 < r.num_batches else None
                )
                for i in range(imgs.shape[0]):
                    stdout.write(
                        unextract_frame(
                            imgs[i], shift, bool(big_endian)
                        ).tobytes()
                    )
                    sys.stderr.write(f"extracted frame {count}\n")
                    count += 1
        return 0

    from fpv_tpu.api.decoder import StreamingDecoder
    from fpv_tpu.api.frame import unextract_frame

    dec = StreamingDecoder()

    def cb(ok, frame, xs, ys, _payload):
        nonlocal count
        if not ok:
            sys.stderr.write("decompressing frame failed\n")
            raise SystemExit(1)
        stdout.write(unextract_frame(frame, shift, bool(big_endian)).tobytes())
        sys.stderr.write(f"extracted frame {count}\n")
        count += 1

    block = 1 << 20
    dec.decode(head, cb)
    while chunk := stdin.read(block):
        dec.decode(chunk, cb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
