"""Profile transcoding: FPV1 (reference-compatible) <-> FPVT (batched device profile).

The migration tool for users of the reference (google/fusion-power-video):
existing .fpv archives convert losslessly to the FPVT profile — whose whole
data path encodes/decodes batched on accelerator — and back, without
re-running the raw capture pipeline.  Pixels are preserved exactly: decoding
the transcoder's output yields frames byte-identical to decoding its input.

FPV1 files do not record the encode-time ``shift``/``big_endian`` arguments
(the reference's encode.cc:41-48 takes them on argv; the file stores only
left-aligned samples, see fusion_power_video.cc:30-155), so
:func:`transcode_to_fpvt` takes them as options and VERIFIES the claim
against the data before trusting it — a wrong shift would otherwise corrupt
samples silently.  FPVT headers do record both, so :func:`transcode_to_fpv1`
carries them over automatically and the output reproduces the original raw
byte contract under ``fpv-decode``.

Memory is bounded batch-wise in both directions (one FPVT batch of frames
in flight, plus the codec's own pipelining).
"""

from __future__ import annotations

import warnings

import numpy as np

from fpv_tpu.format import fpvt as fpvt_format


def sniff_profile(data: bytes) -> str:
    """``"fpvt"`` or ``"fpv1"`` for a container blob.

    FPVT opens with the ``FPVT`` magic; FPV1 has no magic, but its first
    field is xsize u32LE <= 65536 (fusion_power_video.cc:884-895) while the
    magic bytes read as ~1.4e9 — the formats cannot collide."""
    return "fpvt" if bytes(data[:4]) == fpvt_format.MAGIC else "fpv1"


def _aligned_to_raw(
    aligned: np.ndarray, shift: int, big_endian: bool, verify: bool
) -> np.ndarray:
    """Left-aligned decoded samples -> raw uint16 frames for a writer that
    will re-apply (shift, big_endian) at import.

    ``verify`` re-splits the produced raw data and compares the recombined
    planes to the input: a shift claim the samples don't satisfy (nonzero
    bits below the shift) is rejected instead of silently dropped, unlike
    the reference CLI which truncates (fusion_power_video.cc:850-862 is
    only the inverse of import for representable inputs)."""
    from fpv_tpu.api.frame import combine_planes, split_planes, unextract_frame

    if shift == 0 and not big_endian:
        return aligned
    raw = (
        unextract_frame(aligned, shift, big_endian)
        .view("<u2")
        .reshape(aligned.shape)
    )
    if verify:
        p = split_planes(raw, shift, big_endian)
        if not np.array_equal(combine_planes(p.high, p.low), aligned):
            raise ValueError(
                f"samples are not representable at shift={shift} "
                f"big_endian={big_endian}: pass the shift the original raw "
                "capture was encoded with (12-bit data: 4), or 0 to store "
                "the left-aligned samples as-is"
            )
    return raw


def transcode_to_fpvt(
    data: bytes,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    num_threads: int = 4,
) -> bytes:
    """FPV1 container bytes -> FPVT container bytes (lossless).

    ``shift``/``big_endian`` stamp the FPVT header's raw-IO contract (they
    are verified against the samples; FPV1 does not record them).  When the
    FPV1 stream's frame 0 equals its delta frame — the layout the reference
    CLI always produces (encode.cc:86-92) — the FPVT header sets
    HDR_F_DELTA_IS_FRAME0, storing that frame once.
    """
    from concurrent.futures import ThreadPoolExecutor

    from fpv_tpu.api.decoder import RandomAccessDecoder
    from fpv_tpu.api.fpvt_codec import FpvtWriter
    from fpv_tpu.entropy.plane_codec import narrow_max_syms

    dec = RandomAccessDecoder()
    if not dec.init(bytes(data)):
        raise ValueError("invalid FPV1 file")
    h, w = dec.ysize, dec.xsize
    delta = dec.delta_frame
    n = dec.numframes
    delta_is_frame0 = n > 0 and np.array_equal(dec.decode_frame(0), delta)
    first = 1 if delta_is_frame0 else 0
    wri = FpvtWriter(
        w, h, shift, big_endian, frames_per_batch, chunk_log2,
        delta_is_frame0=delta_is_frame0,
        narrow=(n - first) * h * w <= narrow_max_syms(),
    )
    parts = [wri.init(_aligned_to_raw(delta[None], shift, big_endian, True)[0])]
    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        for start in range(first, n, frames_per_batch):
            idx = range(start, min(start + frames_per_batch, n))
            aligned = np.stack(list(pool.map(dec.decode_frame, idx)))
            parts.append(
                wri.encode_batch(
                    _aligned_to_raw(aligned, shift, big_endian, True)
                )
            )
    parts.append(wri.finish())
    return b"".join(parts)


def transcode_to_fpv1(data: bytes, num_threads: int = 4) -> bytes:
    """FPVT container bytes -> FPV1 container bytes (lossless).

    The output decodes to byte-identical frames — with the reference's own
    decoders too — and reproduces the original raw stream under
    ``fpv-decode`` with the header's recorded shift/endianness.  FPV1 has
    no timestamp field (fusion_power_video.cc:30-155); non-default
    timestamps in the input are dropped with a warning.
    """
    from fpv_tpu.api.encoder import Encoder
    from fpv_tpu.api.fpvt_codec import FpvtReader

    r = FpvtReader(bytes(data))
    hdr = r.header
    shift, big_endian = hdr.shift, hdr.big_endian
    raw_delta = _aligned_to_raw(
        r.delta_frame()[None], shift, big_endian, False
    )[0]
    chunks: list[bytes] = []
    cb = lambda out, _payload: chunks.append(out)
    enc = Encoder(
        num_threads=num_threads, shift=shift, big_endian=big_endian
    )
    enc.init(raw_delta, hdr.xsize, hdr.ysize, cb)
    if hdr.delta_is_frame0:
        # FPVT stores this frame once; FPV1 keeps the reference CLI's
        # layout where frame 0 is also a regular frame (encode.cc:86-92)
        enc.compress_frame(raw_delta, cb)
    ts_dropped = False
    for bi in range(r.num_batches):
        ts_dropped = ts_dropped or bool(
            (np.asarray(r.timestamps(bi)) != -1).any()
        )
        raw = _aligned_to_raw(r.decode_batch(bi), shift, big_endian, False)
        for frame in raw:
            enc.compress_frame(frame, cb)
    enc.finish(cb)
    if ts_dropped:
        warnings.warn(
            "FPV1 has no timestamp field; the input's per-frame timestamps "
            "were dropped",
            stacklevel=2,
        )
    return b"".join(chunks)


def transcode(
    data: bytes,
    to_profile: str,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    num_threads: int = 4,
) -> bytes:
    """Transcode ``data`` (profile auto-detected) to ``to_profile``.

    Same-profile input is returned unchanged (already in the target
    container; re-coding would only burn cycles)."""
    if to_profile not in ("fpv1", "fpvt"):
        raise ValueError(f"unknown profile {to_profile!r}")
    src = sniff_profile(data)
    if src == to_profile:
        return bytes(data)
    if to_profile == "fpvt":
        return transcode_to_fpvt(
            data, shift, big_endian, frames_per_batch, chunk_log2,
            num_threads,
        )
    return transcode_to_fpv1(data, num_threads)
