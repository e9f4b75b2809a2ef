"""CODING_RAW stored plane streams (format v6).

An encoder stores a plane batch verbatim whenever its rANS stream would not
be smaller (rans_layout.CODING_RAW — the stored-block role of deflate; the
reference has no equivalent, its brotli-q1 output on noise is strictly
larger than raw, /root/reference/fusion_power_video.cc:166-169).  Decode of
a raw plane is an unpack, not a kernel launch, so incompressible planes are
bounded at memcpy speed both ways.

Covered here: the stream-level serialize/parse roundtrip, the exact-size
encoder decision (and its FPV_TPU_RAW=0 switch), end-to-end lossless
roundtrips on both engines with prediction flags active (the fused
packager re-derives residuals via _residual_planes_for_flags — byte parity
between the fused/device writer and the slow/numpy writer proves that
recompute is integer-exact), every decode path (fused batch, slow, random
access fallback, streaming, sharded), and the malformed-input guards.
"""

import numpy as np
import pytest

from fpv_tpu.api.fpvt_codec import (
    FpvtReader,
    decode_file_fpvt,
    encode_file_fpvt,
)
from fpv_tpu.entropy.plane_codec import (
    PlaneStream,
    coded_stream_bytes,
    decode_plane_batch,
    encode_plane_batch,
    raw_plane_stream,
    raw_stream_bytes,
)
from fpv_tpu.format import fpvt
from fpv_tpu.ops.rans_layout import CODING_CTX16, CODING_ORDER0, CODING_RAW
from fpv_tpu.utils import testdata


def _noisy_low_frames(n: int, h: int, w: int, seed: int = 3) -> np.ndarray:
    """Frames whose high byte drifts smoothly (delta/prev prediction wins)
    while the low byte is iid noise (its residual stream must go raw)."""
    rng = np.random.default_rng(seed)
    base = testdata.plasma_frames(1, h, w, bits=8)[0].astype(np.uint16)
    out = np.empty((n, h, w), np.uint16)
    for t in range(n):
        hi = (base + t) & 0xFF
        out[t] = (hi << 8) | rng.integers(0, 256, size=(h, w)).astype(np.uint16)
    return out


def _stream_codings(data: bytes) -> list[tuple[int, int | None, int | None]]:
    """[(high, low, preview) coding ids] per batch section."""
    r = FpvtReader(data)
    out = []
    for off, _n in r._batches:
        pb = r._parse_batch(off)
        out.append(
            tuple(st.coding if st is not None else None
                  for st in (pb.high, pb.low, pb.preview))
        )
    return out


def test_raw_stream_serialize_parse_roundtrip():
    rng = np.random.default_rng(0)
    for n in (7, 8, 1024):  # odd size exercises the u16 packing pad
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        ps = raw_plane_stream(1, n, 512, data)
        blob = fpvt.serialize_plane_stream(ps)
        assert len(blob) == raw_stream_bytes(n)
        assert len(blob) % 8 == 0
        ps2, end = fpvt.parse_plane_stream(blob, 0, 1, expect_size=n)
        assert end == len(blob)
        assert ps2.coding == CODING_RAW
        np.testing.assert_array_equal(ps2.raw_bytes, data)
        np.testing.assert_array_equal(
            decode_plane_batch(ps2), data.reshape(1, n)
        )
        acc = fpvt.plane_stream_accounting(ps)
        assert acc["total"] == len(blob) and acc["payload"] == n


def test_raw_decision_exact_sizes(monkeypatch):
    """Noise planes go raw; compressible planes stay coded; FPV_TPU_RAW=0
    pins the pre-v6 behavior.  The decision reproduces exact serialized
    sizes (checked against the actual byte strings both ways)."""
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 256, size=(4, 4096), dtype=np.uint8)
    ramp = (np.arange(4 * 4096, dtype=np.uint32) // 64 % 7).astype(
        np.uint8
    ).reshape(4, 4096)

    ps_noise = encode_plane_batch(noise, None, 512, lanes="auto")
    assert ps_noise.coding == CODING_RAW
    assert len(fpvt.serialize_plane_stream(ps_noise)) == raw_stream_bytes(
        noise.size
    )

    ps_ramp = encode_plane_batch(ramp, None, 512, lanes="auto")
    assert ps_ramp.coding == CODING_ORDER0
    coded_len = len(fpvt.serialize_plane_stream(ps_ramp))
    assert coded_len == coded_stream_bytes(
        ps_ramp.num_chunks, ps_ramp.num_groups, int(ps_ramp.payload.size)
    )
    assert coded_len < raw_stream_bytes(ramp.size)

    monkeypatch.setenv("FPV_TPU_RAW", "0")
    ps_off = encode_plane_batch(noise, None, 512, lanes="auto")
    assert ps_off.coding in (CODING_ORDER0, CODING_CTX16)
    # ... and raw was indeed not larger than what the coder produced
    assert raw_stream_bytes(noise.size) <= len(
        fpvt.serialize_plane_stream(ps_off)
    )
    np.testing.assert_array_equal(decode_plane_batch(ps_noise), noise)


def test_noise_file_goes_raw_and_roundtrips():
    """16-bit noise: both main planes store raw, the file beats (or ties)
    the rANS-only writer, and every decode path is lossless."""
    frames = testdata.noise_frames(7, 24, 40, seed=5)
    data = encode_file_fpvt(frames, frames_per_batch=3, chunk_log2=8)
    codings = _stream_codings(data)
    assert all(c[0] == CODING_RAW and c[1] == CODING_RAW for c in codings)
    np.testing.assert_array_equal(decode_file_fpvt(data), frames)

    import os

    os.environ["FPV_TPU_RAW"] = "0"
    try:
        data_coded = encode_file_fpvt(frames, frames_per_batch=3, chunk_log2=8)
    finally:
        del os.environ["FPV_TPU_RAW"]
    assert len(data) <= len(data_coded)
    np.testing.assert_array_equal(decode_file_fpvt(data_coded), frames)


def test_raw_with_prediction_flags_roundtrip():
    """Drifting high byte + noisy low byte: temporal prediction stays on
    (the high plane codes small) while the low residual stores raw — the
    inverse prediction must apply on top of raw-decoded residuals."""
    frames = _noisy_low_frames(6, 24, 40)
    data = encode_file_fpvt(frames, frames_per_batch=5, chunk_log2=8)
    codings = _stream_codings(data)
    assert all(c[1] == CODING_RAW for c in codings)  # noisy low went raw
    assert any(c[0] != CODING_RAW for c in codings)  # high stayed coded
    r = FpvtReader(data)
    flags = r._parse_batch(r._batches[0][0]).frame_flags
    # prediction actually engaged on some frame (delta or prev)
    assert (flags & (fpvt.F_USE_DELTA | fpvt.F_USE_PREV)).any()
    np.testing.assert_array_equal(decode_file_fpvt(data), frames)
    # random access (raw streams fall back to the batch decode)
    for i in (0, 3, 5):
        np.testing.assert_array_equal(r.decode_frame(i), frames[i])


def test_raw_fused_and_slow_writer_byte_parity(monkeypatch):
    """The fused (device) writer's raw stores — recovered on device from
    the flags via _residual_planes_for_flags — are byte-identical to the
    numpy writer's, which stores the model step's residuals directly."""
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")  # force the fused path
    frames = _noisy_low_frames(5, 16, 32, seed=9)
    blobs = {}
    for engine in ("numpy", "interpret"):
        monkeypatch.setenv("FPV_TPU_RANS_ENGINE", engine)
        data = encode_file_fpvt(frames, frames_per_batch=4, chunk_log2=4)
        # at these tiny wide-geometry sizes every plane loses to raw
        assert all(
            c == (CODING_RAW, CODING_RAW, CODING_RAW)
            for c in _stream_codings(data)
        )
        np.testing.assert_array_equal(decode_file_fpvt(data), frames)
        blobs[engine] = data
    assert blobs["numpy"] == blobs["interpret"]


def test_raw_fused_decode_matches_slow(monkeypatch):
    """fused_decode_batch's in-program raw unpack (device engine) matches
    the per-plane slow path on a mixed raw/coded file."""
    frames = _noisy_low_frames(6, 16, 256, seed=13)
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    data = encode_file_fpvt(frames, frames_per_batch=3, chunk_log2=6)
    r = FpvtReader(data)
    out_fused = [
        r.decode_batch_with_previews(i) for i in range(r.num_batches)
    ]
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "numpy")
    r2 = FpvtReader(data)
    for i, (imgs, pv) in enumerate(out_fused):
        imgs2, pv2 = r2.decode_batch_with_previews(i)
        np.testing.assert_array_equal(imgs, imgs2)
        np.testing.assert_array_equal(pv, pv2)
    # frame 0 is the delta section (delta_is_frame0); batches hold the rest
    np.testing.assert_array_equal(r.frame0(), frames[0])
    np.testing.assert_array_equal(
        np.concatenate([o[0] for o in out_fused]), frames[1:]
    )


def test_raw_streaming_reader(monkeypatch):
    """FpvtStreamingReader over a raw-plane file fed in small chunks."""
    from fpv_tpu.api.fpvt_codec import FpvtStreamingReader

    frames = testdata.noise_frames(6, 16, 24, seed=21)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=8)
    got = []
    sr = FpvtStreamingReader(lambda imgs, ts: got.append(imgs))
    for i in range(0, len(data), 499):
        sr.decode(data[i : i + 499])
    np.testing.assert_array_equal(np.concatenate(got), frames)


def test_sharded_encode_raw_byte_identical(monkeypatch):
    """sharded_encode_file == encode_file_fpvt byte-for-byte when planes
    store raw (the packager's recovery path runs on both sides), and
    sharded_decode_file groups/decodes raw sections in-program."""
    from fpv_tpu.parallel import mesh as pmesh

    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    D, h, w, bpb = 2, 16, 16, 2
    m = pmesh.make_mesh(D, data=D)
    n = 1 + 2 * D * bpb  # delta frame + 2 mesh groups
    frames = _noisy_low_frames(n, h, w, seed=31)
    kwargs = dict(frames_per_batch=bpb, chunk_log2=4)
    got = pmesh.sharded_encode_file(frames, m, **kwargs)
    want = encode_file_fpvt(frames, **kwargs)
    assert got == want
    assert any(
        CODING_RAW in c for c in _stream_codings(got)
    )
    np.testing.assert_array_equal(decode_file_fpvt(got), frames)
    np.testing.assert_array_equal(pmesh.sharded_decode_file(got, m), frames)


def test_raw_malformed_inputs():
    """Truncated / size-inconsistent raw streams fail at parse time."""
    data = (np.arange(64) % 256).astype(np.uint8)
    ps = raw_plane_stream(1, 64, 512, data)
    blob = fpvt.serialize_plane_stream(ps)
    with pytest.raises(ValueError):
        fpvt.parse_plane_stream(blob[:40], 0, 1, expect_size=64)
    with pytest.raises(ValueError):
        # geometry mismatch: claimed plane size != header geometry
        fpvt.parse_plane_stream(blob, 0, 1, expect_size=32)
    with pytest.raises(ValueError):
        # more frames than the stored bytes cover
        fpvt.parse_plane_stream(blob, 0, 2, expect_size=64)


def test_raw_u8_input_roundtrip():
    """8-bit direct input with incompressible content: the single high
    plane stores raw and decode returns uint8."""
    rng = np.random.default_rng(17)
    frames = rng.integers(0, 256, size=(5, 16, 24), dtype=np.uint8)
    data = encode_file_fpvt(frames, shift=8, frames_per_batch=2, chunk_log2=8)
    codings = _stream_codings(data)
    assert all(c[0] == CODING_RAW for c in codings)
    out = decode_file_fpvt(data, dtype=np.uint8)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, frames)
