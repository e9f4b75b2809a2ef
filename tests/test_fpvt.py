"""FPVT (device profile) container + codec tests."""

import numpy as np
import pytest

from fpv_tpu.api.fpvt_codec import (
    FpvtReader,
    FpvtWriter,
    decode_file_fpvt,
    encode_file_fpvt,
)
from fpv_tpu.format import fpvt
from fpv_tpu.utils import testdata


def _leftaligned(frames, shift):
    return (frames.astype(np.uint16) << shift).astype(np.uint16)


@pytest.mark.parametrize("bits,shift", [(16, 0), (12, 4), (8, 8)])
def test_fpvt_roundtrip(bits, shift):
    frames = testdata.plasma_frames(10, 48, 64, bits=bits)
    data = encode_file_fpvt(frames, shift=shift, frames_per_batch=4, chunk_log2=9)
    out = decode_file_fpvt(data)
    np.testing.assert_array_equal(out, _leftaligned(frames, shift))


def test_fpvt_roundtrip_noise_and_constant():
    for frames in (testdata.noise_frames(5, 32, 32), testdata.constant_frames(5, 32, 32)):
        data = encode_file_fpvt(frames, frames_per_batch=3, chunk_log2=8)
        np.testing.assert_array_equal(decode_file_fpvt(data), frames)


def test_fpvt_random_access():
    frames = testdata.plasma_frames(9, 32, 48)
    data = encode_file_fpvt(frames, frames_per_batch=4, chunk_log2=8)
    r = FpvtReader(data)
    assert r.numframes == 9
    # frame 0 is the delta frame itself (HDR_F_DELTA_IS_FRAME0): batches
    # hold the remaining 8 frames
    assert r.header.delta_is_frame0
    assert r.num_batches == 2
    for i in (8, 0, 5, 3):
        np.testing.assert_array_equal(r.decode_frame(i), frames[i])


def test_fpvt_previews():
    frames = testdata.plasma_frames(4, 64, 64)
    data = encode_file_fpvt(frames, frames_per_batch=4, chunk_log2=8)
    r = FpvtReader(data)
    high = (frames >> 8).astype(np.uint32)
    expect = (
        high.reshape(4, 16, 4, 16, 4).sum(axis=(2, 4)) // 16
    ).astype(np.uint8) & 0xFE
    # frames 1..3 live in batch 0 (frame 0 is the delta frame)
    pv = r.decode_previews(0)
    assert pv.shape == (3, 16, 16)
    np.testing.assert_array_equal(pv, expect[1:])
    # per-frame accessor covers every frame incl. the synthesized frame 0
    for i in range(4):
        np.testing.assert_array_equal(r.preview_frame(i), expect[i])


def test_preview_stream_own_chunk():
    """Preview streams carry their own (shorter) chunk on the wire.

    The plane-stream header has always stored chunk_len per stream
    (format/fpvt.py); new writers code previews at PV_CHUNK_MAX so
    big-frame previews land in many rANS blocks instead of one
    under-occupied one (the ~20 ms preview gap of the 4096^2 bench).
    The wide fused path, the preview-only decoder, and the slow
    per-plane path must all honor it."""
    from fpv_tpu.api.fpvt_codec import PV_CHUNK_MAX, FpvtWriter
    from fpv_tpu.ops.preview import generate_preview

    frames = testdata.plasma_frames(3, 256, 256, bits=12)
    w = FpvtWriter(256, 256, shift=4, frames_per_batch=2, chunk_log2=12,
                   narrow=False)
    data = w.init(frames[0]) + w.encode_batch(frames[1:]) + w.finish()
    r = FpvtReader(data)
    pb = r._parse_batch(r._batches[0][0])
    assert pb.high.chunk_len == 4096
    assert pb.preview.chunk_len == PV_CHUNK_MAX
    # the init frame is the delta frame only (no HDR_F_DELTA_IS_FRAME0 on
    # the manual writer path): the file body is frames[1:]
    np.testing.assert_array_equal(
        decode_file_fpvt(data), frames[1:].astype(np.uint16) << 4
    )
    pv = r.decode_previews(0)
    expect = np.asarray(
        generate_preview(((frames.astype(np.uint16) << 4) >> 8)
                         .astype(np.uint8))
    )
    np.testing.assert_array_equal(pv, expect[1:])


def test_fpvt_compression_beats_raw():
    frames = testdata.plasma_frames(8, 256, 256, bits=12)
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=8)
    assert len(data) < frames.nbytes * 0.7


def test_fpvt_timestamps():
    frames = testdata.plasma_frames(4, 32, 32)
    w = FpvtWriter(32, 32, frames_per_batch=4)
    parts = [w.init(frames[0])]
    ts = np.array([10, 20, 30, 40], dtype=np.int64)
    parts.append(w.encode_batch(frames, timestamps=ts))
    parts.append(w.finish())
    r = FpvtReader(b"".join(parts))
    np.testing.assert_array_equal(r.timestamps(0), ts)


def test_fpvt_corruption_detected():
    frames = testdata.plasma_frames(4, 32, 32)
    data = bytearray(encode_file_fpvt(frames, frames_per_batch=4, chunk_log2=8))
    # flip a byte inside the first batch payload (after header+delta)
    data[len(data) // 2] ^= 0xA5
    with pytest.raises(ValueError):
        decode_file_fpvt(bytes(data))


def test_fpvt_header_roundtrip():
    h = fpvt.Header(xsize=1024, ysize=768, shift=4, big_endian=True,
                    chunk_log2=11, frames_per_batch=32)
    h2 = fpvt.Header.parse(h.serialize())
    assert h == h2


def test_fpvt_prefix_decodable_without_footer():
    """Header + delta + complete batches decode without the footer."""
    frames = testdata.plasma_frames(6, 32, 32)
    w = FpvtWriter(32, 32, frames_per_batch=3, chunk_log2=8)
    parts = [w.init(frames[0])]
    parts.append(w.encode_batch(frames[:3]))
    first_batch_end = sum(len(p) for p in parts)
    parts.append(w.encode_batch(frames[3:]))
    parts.append(w.finish())
    data = b"".join(parts)
    # manually walk sections of the truncated prefix
    import struct

    prefix = data[:first_batch_end]
    pos = fpvt.HEADER_SIZE
    size, stype = struct.unpack_from("<QB", prefix, pos)
    assert stype == fpvt.SECTION_DELTA
    pos += size
    pb = fpvt.parse_batch_section(prefix, pos)
    assert len(pb.frame_flags) == 3


def test_fpvt_streaming_reader():
    """Chunked feed through the FPVT streaming reader, including truncation."""
    from fpv_tpu.api.fpvt_codec import FpvtStreamingReader

    frames = testdata.plasma_frames(6, 32, 32)
    data = encode_file_fpvt(frames, frames_per_batch=3, chunk_log2=8)
    got_frames, got_ts = [], []

    def cb(imgs, ts):
        got_frames.append(imgs)
        got_ts.append(ts)

    r = FpvtStreamingReader(cb)
    for pos in range(0, len(data), 113):
        r.decode(data[pos : pos + 113])
    out = np.concatenate(got_frames)
    np.testing.assert_array_equal(out, frames)

    # truncated: cut inside the second batch -> only first batch delivered
    import struct

    pos = 32
    sections = []
    while pos + 9 <= len(data):
        size, stype = struct.unpack_from("<QB", data, pos)
        sections.append((pos, size, stype))
        pos += size
    batch_secs = [s for s in sections if s[2] == 0]
    cut = batch_secs[1][0] + 20
    got_frames.clear()
    r2 = FpvtStreamingReader(cb)
    r2.decode(data[:cut])
    # frame 0 (synthesized from the delta section) + the first batch
    assert len(got_frames) == 2
    np.testing.assert_array_equal(np.concatenate(got_frames), frames[:4])


def test_fpvt_malformed_inputs_rejected():
    import struct as _s

    with pytest.raises(ValueError):
        FpvtReader(b"NOPE" + b"\0" * 60)
    with pytest.raises(ValueError):
        fpvt.Header.parse(b"FPVT" + b"\0" * 10)  # too small
    # oversized dims
    bad = _s.pack("<4sBBHIIBBHIQ", b"FPVT", 1, 1, 0, 70000, 70000, 0, 9, 0, 16, 0)
    with pytest.raises(ValueError):
        fpvt.Header.parse(bad)
    # valid header but garbage body
    good = fpvt.Header(xsize=32, ysize=32).serialize()
    with pytest.raises(Exception):
        FpvtReader(good + b"\0" * 64)


def test_fpvt_per_block_random_access(monkeypatch):
    """decode_frame on the device engine decodes only the covering blocks
    (no batch decode, no cache fill) and matches the full decode."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    # pin the 1024-lane device geometry: the narrow-stream policy would
    # otherwise host-code these tiny planes (no per-block path), and the
    # CODING_RAW policy would store them (wide-geometry states outweigh
    # coded payloads at test sizes; raw streams have no per-block path)
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    monkeypatch.setenv("FPV_TPU_RAW", "0")
    frames = testdata.plasma_frames(6, 32, 32, bits=12)
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=3, chunk_log2=4)
    r = FpvtReader(data)
    for i in (5, 0, 4, 2):
        np.testing.assert_array_equal(
            r.decode_frame(i), frames[i].astype(np.uint16) << 4
        )
        assert r._cache is None  # block path, not batch decode


@pytest.mark.parametrize("engine", ["numpy", "interpret"])
def test_fpvt_tiny_dims_roundtrip(engine, monkeypatch):
    """H<4 / W<4 frames have zero-pixel previews: the preview stream is
    skipped and both engines roundtrip (advisor finding: the numpy engine
    used to crash on the empty preview histogram)."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", engine)
    frames = testdata.noise_frames(2, 3, 3)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=4)
    np.testing.assert_array_equal(decode_file_fpvt(data), frames)
    r = FpvtReader(data)
    off, _b = r._batches[0]
    pb = fpvt.parse_batch_section(data, off)
    assert pb.preview is None
    # batch 0 holds one frame (frame 0 is the delta frame)
    assert r.decode_previews(0).shape == (1, 0, 0)


def test_fpvt_single_frame_file():
    """A 1-frame sequence stores ONLY the delta section (delta_is_frame0):
    zero batch sections, frame synthesized on decode, all readers agree."""
    from fpv_tpu.api.fpvt_codec import FpvtStreamingReader

    frames = testdata.plasma_frames(1, 32, 32, bits=12)
    data = encode_file_fpvt(frames, shift=4)
    out = decode_file_fpvt(data)
    np.testing.assert_array_equal(out, (frames.astype(np.uint16) << 4))
    r = FpvtReader(data)
    assert r.numframes == 1 and r.num_batches == 0
    np.testing.assert_array_equal(r.decode_frame(0), out[0])
    got = []
    sr = FpvtStreamingReader(lambda imgs, ts: got.append(imgs))
    sr.decode(data)
    np.testing.assert_array_equal(np.concatenate(got), out)


def test_fpvt_explicit_delta_keeps_all_frames_in_batches():
    """Passing delta_frame explicitly keeps the legacy layout (no header
    flag, every input frame coded in batches)."""
    frames = testdata.plasma_frames(4, 32, 32, bits=12)
    ref = frames[0] // 2  # distinct delta frame
    data = encode_file_fpvt(frames, shift=4, delta_frame=ref,
                            frames_per_batch=4)
    r = FpvtReader(data)
    assert not r.header.delta_is_frame0
    assert r.numframes == 4
    np.testing.assert_array_equal(
        decode_file_fpvt(data), (frames.astype(np.uint16) << 4)
    )


def test_fpvt_footer_o1_and_magic_collision():
    """Footer is located from the fixed-size tail, not a backward scan — a
    fake magic+size pattern in the last batch's payload must not confuse it."""
    frames = testdata.plasma_frames(6, 16, 16)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=4)
    batches = fpvt.parse_footer(data)
    assert len(batches) == 3
    assert fpvt.footer_size(3) == 33 + 36
    # appending garbage that ends with a bogus size+magic is rejected
    bogus = data + b"\x00" * 21 + np.uint32(33).tobytes() + b"FPVT"
    with pytest.raises(ValueError):
        fpvt.parse_footer(bogus)


def test_fpvt_fuzz_single_byte_mutations():
    """Arbitrary single-byte mutations either still decode or raise
    ValueError — never IndexError/struct.error/segfault-adjacent errors."""
    frames = testdata.plasma_frames(4, 16, 16)
    data = bytearray(encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=4))
    rng = np.random.default_rng(7)
    for _ in range(150):
        i = int(rng.integers(0, len(data)))
        old = data[i]
        data[i] ^= int(rng.integers(1, 256))
        try:
            decode_file_fpvt(bytes(data))
        except ValueError:
            pass
        finally:
            data[i] = old


def test_fpvt_fuzz_truncations():
    frames = testdata.plasma_frames(4, 16, 16)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=4)
    rng = np.random.default_rng(8)
    cuts = sorted(set(int(c) for c in rng.integers(0, len(data), 40)))
    for cut in cuts:
        try:
            decode_file_fpvt(data[:cut])
        except ValueError:
            pass


def test_multistream_encoder():
    from fpv_tpu.api.multistream import MultiStreamEncoder
    from fpv_tpu.api.fpvt_codec import decode_file_fpvt

    streams = {
        "a": testdata.plasma_frames(7, 32, 32, seed=1),
        "b": testdata.ramp_frames(5, 32, 32),
        "c": testdata.noise_frames(4, 32, 32),
    }
    out: dict[str, list] = {k: [] for k in streams}
    hub = MultiStreamEncoder(32, 32, frames_per_batch=3, chunk_log2=8,
                             sink=lambda sid, d: out[sid].append(d))
    for sid, fr in streams.items():
        hub.add_stream(sid, fr[0])
    # interleave pushes across streams
    for i in range(7):
        for sid, fr in streams.items():
            if i < len(fr):
                hub.push_frame(sid, 1000 + i, fr[i])
    hub.close()
    for sid, fr in streams.items():
        data = b"".join(out[sid])
        np.testing.assert_array_equal(decode_file_fpvt(data), fr)


def test_multistream_decoder():
    """Encode hub -> decode hub roundtrip with interleaved chunked feeds."""
    from fpv_tpu.api.multistream import MultiStreamDecoder, MultiStreamEncoder

    streams = {
        "a": testdata.plasma_frames(6, 32, 32, seed=2),
        "b": testdata.noise_frames(4, 32, 32),
    }
    enc_out: dict[str, list] = {k: [] for k in streams}
    hub = MultiStreamEncoder(32, 32, frames_per_batch=2, chunk_log2=8,
                             sink=lambda sid, d: enc_out[sid].append(d))
    for sid, fr in streams.items():
        hub.add_stream(sid, fr[0])
    for i in range(6):
        for sid, fr in streams.items():
            if i < len(fr):
                hub.push_frame(sid, 100 + i, fr[i])
    hub.close()

    got: dict[str, list] = {k: [] for k in streams}
    got_ts: dict[str, list] = {k: [] for k in streams}
    dec = MultiStreamDecoder(
        sink=lambda sid, frames, ts: (got[sid].append(frames),
                                      got_ts[sid].append(ts))
    )
    for sid in streams:
        dec.add_stream(sid)
    # interleave 97-byte chunks across streams
    data = {sid: b"".join(enc_out[sid]) for sid in streams}
    pos = 0
    while any(pos < len(d) for d in data.values()):
        for sid, d in data.items():
            if pos < len(d):
                dec.feed(sid, d[pos : pos + 97])
        pos += 97
    dec.close()
    for sid, fr in streams.items():
        np.testing.assert_array_equal(np.concatenate(got[sid]), fr)
        # hub streams code every pushed frame (no delta_is_frame0 flag)
        np.testing.assert_array_equal(
            np.concatenate(got_ts[sid]), 100 + np.arange(len(fr))
        )


def test_multistream_multi_device_assignment():
    """Streams round-robin across devices; results stay correct."""
    import jax

    from fpv_tpu.api.fpvt_codec import decode_file_fpvt
    from fpv_tpu.api.multistream import MultiStreamEncoder

    devs = jax.devices()[:4]
    streams = {f"cam{i}": testdata.plasma_frames(4, 32, 32, seed=i) for i in range(4)}
    out: dict[str, list] = {k: [] for k in streams}
    hub = MultiStreamEncoder(32, 32, frames_per_batch=2, chunk_log2=8,
                             sink=lambda sid, d: out[sid].append(d),
                             devices=devs)
    for sid, fr in streams.items():
        hub.add_stream(sid, fr[0])
    # delta planes should land on distinct devices
    assigned = {w._delta_high.devices().pop() for w in hub._writers.values()}
    assert len(assigned) == len(devs)
    for i in range(4):
        for sid, fr in streams.items():
            hub.push_frame(sid, i, fr[i])
    hub.close()
    for sid, fr in streams.items():
        np.testing.assert_array_equal(decode_file_fpvt(b"".join(out[sid])), fr)


def test_multistream_decoder_multi_device(monkeypatch):
    """Decoder-hub twin of the encoder's round-robin assignment: readers pin
    to distinct devices and the fused decode program runs on the pinned
    device (jax.default_device scope) — outputs stay pixel-exact."""
    import jax

    from fpv_tpu.api.fpvt_codec import encode_file_fpvt
    from fpv_tpu.api.multistream import MultiStreamDecoder

    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    # device geometry on tiny planes so the FUSED (pinned) path executes
    # (and coded streams, not CODING_RAW stores — see per-block RA test)
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    monkeypatch.setenv("FPV_TPU_RAW", "0")
    devs = jax.devices()[:4]
    streams = {
        f"cam{i}": testdata.plasma_frames(5, 32, 32, seed=10 + i)
        for i in range(4)
    }
    enc = {
        sid: encode_file_fpvt(fr, shift=4, frames_per_batch=2, chunk_log2=4)
        for sid, fr in streams.items()
    }
    got: dict[str, list] = {k: [] for k in streams}
    hub = MultiStreamDecoder(
        sink=lambda sid, fr, ts: got[sid].append(fr), devices=devs
    )
    for sid in streams:
        hub.add_stream(sid)
    for sid, d in enc.items():
        hub.feed(sid, d)
    hub.close()
    assigned = {
        r._inner._delta_high.devices().pop() for r in hub._readers.values()
    }
    assert len(assigned) == len(devs)
    for sid, fr in streams.items():
        want = (fr.astype(np.uint32) << 4).astype(np.uint16)
        np.testing.assert_array_equal(np.concatenate(got[sid]), want)


def test_multistream_hubs_multi_device_roundtrip():
    """Encode hub -> decode hub with round-robin device assignment on BOTH
    sides (streams land on different chips end to end); interleaved chunked
    feeds; frames and timestamps exact per stream."""
    import jax

    from fpv_tpu.api.multistream import MultiStreamDecoder, MultiStreamEncoder

    devs = jax.devices()[:3]
    streams = {
        f"cam{i}": testdata.plasma_frames(4, 32, 32, seed=20 + i)
        for i in range(3)
    }
    enc_out: dict[str, list] = {k: [] for k in streams}
    hub = MultiStreamEncoder(32, 32, frames_per_batch=2, chunk_log2=8,
                             sink=lambda sid, d: enc_out[sid].append(d),
                             devices=devs)
    for sid, fr in streams.items():
        hub.add_stream(sid, fr[0])
    for i in range(4):
        for sid, fr in streams.items():
            hub.push_frame(sid, 50 + i, fr[i])
    hub.close()

    got: dict[str, list] = {k: [] for k in streams}
    got_ts: dict[str, list] = {k: [] for k in streams}
    dec = MultiStreamDecoder(
        sink=lambda sid, fr, ts: (got[sid].append(fr),
                                  got_ts[sid].append(ts)),
        devices=devs,
    )
    for sid in streams:
        dec.add_stream(sid)
    data = {sid: b"".join(enc_out[sid]) for sid in streams}
    pos = 0
    while any(pos < len(d) for d in data.values()):
        for sid, d in data.items():
            if pos < len(d):
                dec.feed(sid, d[pos : pos + 173])
        pos += 173
    dec.close()
    for sid, fr in streams.items():
        np.testing.assert_array_equal(np.concatenate(got[sid]), fr)
        np.testing.assert_array_equal(
            np.concatenate(got_ts[sid]), 50 + np.arange(4)
        )


def test_multistream_decoder_sink_error_propagates():
    """A sink that raises inside the finalize stage must surface as a
    RuntimeError from feed()/close(), not hang either pipeline worker."""
    import pytest

    from fpv_tpu.api.fpvt_codec import encode_file_fpvt
    from fpv_tpu.api.multistream import MultiStreamDecoder

    frames = testdata.plasma_frames(4, 32, 32, seed=7)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=8)

    def sink(sid, imgs, ts):
        raise ValueError("sink boom")

    hub = MultiStreamDecoder(sink=sink)
    hub.add_stream("s")
    with pytest.raises(RuntimeError):
        hub.feed("s", data)
        hub.close()


def test_multistream_decoder_issue_error_stops_finalizer():
    """An issue-stage failure (corrupt stream) must deliver the finalizer
    its shutdown sentinel even with finalizes pending — close() surfaces
    the error promptly and neither worker thread is leaked blocked."""
    import time

    import pytest

    from fpv_tpu.api.fpvt_codec import encode_file_fpvt
    from fpv_tpu.api.multistream import MultiStreamDecoder

    import struct

    frames = testdata.plasma_frames(9, 32, 32, seed=9)
    data = bytearray(encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=8))
    # corrupt the LAST batch section's high-stream lane count so the issue
    # worker errors AFTER several finalizes are already queued
    off, nfr = fpvt.parse_footer(bytes(data))[-1]
    struct.pack_into("<H", data, off + 9 + 8 + 9 * nfr + 4 + 16, 7)

    def slow_sink(sid, imgs, ts):
        time.sleep(0.3)  # keeps the finalize queue full when the error hits

    hub = MultiStreamDecoder(sink=slow_sink)
    hub.add_stream("s")
    t0 = time.time()
    with pytest.raises(RuntimeError):
        hub.feed("s", bytes(data))
        hub.close()
    assert time.time() - t0 < 60  # not the 600 s join timeout
    for _ in range(100):
        if not hub._worker.is_alive() and not hub._finalizer.is_alive():
            break
        time.sleep(0.1)
    assert not hub._worker.is_alive()
    assert not hub._finalizer.is_alive()


def test_fused_pack_u8_matches_slow_path(monkeypatch):
    """The fused decode's u8-byte-stream output (device bitcast + host view,
    see fused_decode_batch pack_u8) must match the per-plane slow path
    byte-for-byte — guards the little-endian byte order and the
    [b*h, 2w] -> [b, h, w] view across platforms."""
    from fpv_tpu.api.fpvt_codec import FpvtReader, encode_file_fpvt

    frames = testdata.plasma_frames(6, 64, 128, bits=12, seed=11)
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    # disable narrow streams so small test planes still get the 1024-lane
    # device geometry the fused program requires
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    # chunk_log2=8: interpret-mode kernels iterate every chunk step, so the
    # default 4096-step chunks would cost minutes here
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=3, chunk_log2=8)
    r = FpvtReader(data)
    for i in range(r.num_batches):
        off, b = r._batches[i]
        from fpv_tpu.format import fpvt as _f

        pb = _f.parse_batch_section(data, off)
        fast, pv_f = r._decode_batch_fused(pb, b, decode_preview=True)
        slow, pv_s = r._decode_parsed_batch_slow(pb, b, want_previews=True)
        np.testing.assert_array_equal(fast, slow)
        np.testing.assert_array_equal(pv_f, pv_s)


def test_header_rejects_big_endian_large_shift():
    from fpv_tpu.format.fpvt import Header

    hdr = Header(xsize=32, ysize=32, shift=12, big_endian=True)
    blob = bytearray(hdr.serialize())
    with pytest.raises(ValueError):
        Header.parse(bytes(blob))
    # the same shift little-endian parses fine
    assert Header.parse(Header(xsize=32, ysize=32, shift=12).serialize())


def test_serialize_batch_section_rejects_timestamp_mismatch():
    frames = testdata.plasma_frames(3, 16, 16)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=4)
    off, _ = fpvt.parse_footer(data)[0]
    pb = fpvt.parse_batch_section(data, off)
    with pytest.raises(ValueError):
        fpvt.serialize_batch_section(
            pb.frame_flags, pb.timestamps[:-1], pb.high, pb.low, pb.preview
        )


def test_writer_rejects_oversize_device_batch():
    """1 frame x 65536^2 = 2^32 symbols exceeds MAX_DEVICE_SYMS: the guard
    fires before any real frame data is touched (int32 payload-offset
    cumsums inside the fused programs would otherwise wrap silently)."""
    w = FpvtWriter(65536, 65536, frames_per_batch=1)
    w._delta_high = w._delta_low = object()  # skip init for the guard test
    with pytest.raises(ValueError, match="2\\^31 symbols"):
        # only .shape[0] is read before the guard; a tiny stand-in array
        # exercises the check without 8 GB of frames
        w.encode_batch_bytes(np.zeros((1, 4, 4), np.uint16))


def test_warmup_stream_runs_for_geometry():
    """warmup_stream pre-compiles the fused encode/decode programs for a
    geometry (with and without previews, optionally pinned to a device)."""
    import jax

    from fpv_tpu.api.fpvt_codec import warmup_stream

    warmup_stream(32, 32, shift=4, frames_per_batch=2, chunk_log2=8)
    warmup_stream(
        32, 32, shift=4, frames_per_batch=2, chunk_log2=8,
        previews=True, device=jax.devices()[-1],
    )


def _drift_frames(n, h, w):
    """Temporally-correlated corpus: frame t is frame 0 translated, so the
    prev-frame residual is small while the static-delta residual grows."""
    pl = testdata.plasma_frames(1, h, w, bits=12, seed=3)[0]
    return np.stack(
        [np.roll(pl, (2 * i, 3 * i), (0, 1)) for i in range(n)]
    ).astype(np.uint16)


def test_temporal_prev_roundtrip_smaller_and_anchored():
    """F_USE_PREV (v5): drifting content picks prev-frame prediction, the
    file is lossless AND smaller than the static-delta-only encoding, and
    the writer's PREV_ANCHOR policy holds (anchor frames never use prev)."""
    from fpv_tpu.api.fpvt_codec import PREV_ANCHOR, file_encode_setup

    n, h, w = 12, 48, 64
    frames = _drift_frames(n, h, w)
    want = _leftaligned(frames, 4)
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=6, chunk_log2=8)
    r = FpvtReader(data)
    saw_prev = False
    for off, _b in r._batches:
        flags = r._parse_batch(off).frame_flags
        up = (flags & fpvt.F_USE_PREV) != 0
        saw_prev |= bool(up.any())
        assert not up[::PREV_ANCHOR].any(), "anchor frame used prev"
        both = (flags & fpvt.F_USE_PREV) & ((flags & fpvt.F_USE_DELTA) << 7)
        assert not both.any(), "prev and static delta flagged together"
    assert saw_prev, "drifting content never picked prev-frame prediction"
    np.testing.assert_array_equal(decode_file_fpvt(data), want)

    # static-only writer (temporal_prev=False): also lossless, but larger
    wri, _hdr, body, _ts = file_encode_setup(
        frames, 4, False, 6, 8, None, None
    )
    wri2 = FpvtWriter(
        w, h, shift=4, frames_per_batch=6, chunk_log2=8,
        temporal_prev=False, narrow=wri._narrow,
        delta_is_frame0=wri.header.delta_is_frame0,
    )
    parts = [wri2.init(frames[0])]
    for s in range(0, body.shape[0], 6):
        sec = wri2.encode_batch_bytes(body[s : s + 6])
        parts.append(wri2.add_batch(sec, min(6, body.shape[0] - s)))
    parts.append(wri2.finish())
    data_static = b"".join(parts)
    np.testing.assert_array_equal(decode_file_fpvt(data_static), want)
    assert len(data) < len(data_static), (
        f"prev file {len(data)} not smaller than static {len(data_static)}"
    )


def test_temporal_prev_fused_paths_and_random_access(monkeypatch):
    """Prev-frame prediction through the FUSED device programs (interpret
    mode): whole-batch decode, previews-in-program, and the single-frame
    random-access path, which must resolve prev chains by walking back to
    the anchor (fused_decode_frame with the previous frame's planes)."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    n, h, w = 6, 32, 128
    frames = _drift_frames(n, h, w)
    want = _leftaligned(frames, 4)
    wri = FpvtWriter(w, h, shift=4, frames_per_batch=6, chunk_log2=5,
                     narrow=False, delta_is_frame0=True)
    parts = [wri.init(frames[0])]
    parts.append(wri.add_batch(wri.encode_batch_bytes(frames[1:]), n - 1))
    parts.append(wri.finish())
    data = b"".join(parts)
    r = FpvtReader(data)
    pb = r._parse_batch(r._batches[0][0])
    assert ((pb.frame_flags & fpvt.F_USE_PREV) != 0).any()
    np.testing.assert_array_equal(decode_file_fpvt(data), want)
    imgs, pv = r.decode_batch_with_previews(0)
    np.testing.assert_array_equal(imgs, want[1:])
    assert pv.shape == (n - 1, h // 4, w // 4)
    # random access on every frame, defeating the batch cache so the
    # chain path (blocks-only decode per chain frame) actually runs
    for i in range(n):
        r._cache = None
        np.testing.assert_array_equal(r.decode_frame(i), want[i])


def test_temporal_prev_random_access_out_of_order(monkeypatch):
    """The chain cache must only accelerate, never corrupt: arbitrary
    access order (backward jumps, repeats, cross-batch) stays exact."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    n, h, w = 12, 32, 128
    frames = _drift_frames(n, h, w)
    want = _leftaligned(frames, 4)
    wri = FpvtWriter(w, h, shift=4, frames_per_batch=6, chunk_log2=5,
                     narrow=False, delta_is_frame0=True)
    parts = [wri.init(frames[0])]
    for s in range(1, n, 6):
        sub = frames[s : s + 6]
        parts.append(wri.add_batch(wri.encode_batch_bytes(sub), len(sub)))
    parts.append(wri.finish())
    r = FpvtReader(b"".join(parts))
    for i in (5, 3, 5, 9, 2, 11, 0, 7, 7, 4):
        r._cache = None  # defeat the batch cache; exercise the chain path
        np.testing.assert_array_equal(r.decode_frame(i), want[i], err_msg=str(i))


def test_version_compat_window():
    """Every version in READ_VERSIONS reads losslessly under current
    semantics (older versions only reserved bits/codings the current reader
    understands); versions outside the window are rejected."""
    # iid noise: no frame ever picks prev (bit 7 unset everywhere).  For the
    # relabeled bytes to be truly valid for pre-v6 readers they must also
    # contain no CODING_RAW streams (invalid before v6) — noise planes DO go
    # raw under the v6 policy, so encode with it disabled and assert both
    # properties rather than assume them.
    frames = testdata.noise_frames(3, 32, 32)
    monkey = pytest.MonkeyPatch()
    monkey.setenv("FPV_TPU_RAW", "0")
    try:
        data = bytearray(
            encode_file_fpvt(frames, frames_per_batch=3, chunk_log2=8))
    finally:
        monkey.undo()
    assert data[4] == fpvt.VERSION
    pb = FpvtReader(bytes(data))._parse_batch(
        FpvtReader(bytes(data))._batches[0][0]
    )
    assert not (pb.frame_flags & fpvt.F_USE_PREV).any()
    from fpv_tpu.ops.rans_layout import CODING_RAW

    assert all(ps is None or ps.coding != CODING_RAW
               for ps in (pb.high, pb.low, pb.preview)), (
        "batch emitted CODING_RAW; relabeling would not be v4/v5-valid")
    want = decode_file_fpvt(bytes(data))
    for ver in fpvt.READ_VERSIONS:
        data[4] = ver
        np.testing.assert_array_equal(decode_file_fpvt(bytes(data)), want)
    for bad in (min(fpvt.READ_VERSIONS) - 1, fpvt.VERSION + 1):
        data[4] = bad
        with pytest.raises(ValueError, match="version"):
            FpvtReader(bytes(data))


def test_device_frames_sink():
    """device_frames=True delivers frames/previews as device arrays LEFT on
    the device (the serving mode for on-device consumers); pixel values and
    timestamps match the host-path decode exactly."""
    import jax

    from fpv_tpu.api.multistream import MultiStreamDecoder

    frames = testdata.plasma_frames(6, 32, 32, seed=7)
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=2, chunk_log2=8)

    got: list = []
    hub = MultiStreamDecoder(
        sink=lambda sid, fr, ts, pv: got.append((fr, ts, pv)),
        want_previews=True, device_frames=True,
    )
    hub.add_stream("s")
    hub.feed("s", data)
    hub.close()

    assert got, "sink never called"
    for fr, _ts, pv in got:
        assert isinstance(fr, jax.Array), type(fr)
        assert pv is None or isinstance(pv, jax.Array), type(pv)

    out = np.concatenate([np.asarray(fr).astype(np.uint16) for fr, _, _ in got])
    # device_frames skips the u8 pack: frames may arrive as u16 already
    np.testing.assert_array_equal(
        out.reshape(-1, 32, 32), _leftaligned(frames, 4)
    )


def test_device_frames_slow_path(monkeypatch):
    """device_frames on the non-fused (slow) decode path still returns
    device arrays with exact pixels (raw-coded planes force the fallback)."""
    import jax

    from fpv_tpu.api.fpvt_codec import FpvtStreamingReader

    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "numpy")
    frames = testdata.plasma_frames(4, 32, 32, seed=3)
    data = encode_file_fpvt(frames, frames_per_batch=2, chunk_log2=8)

    got: list = []
    rdr = FpvtStreamingReader(
        lambda fr, ts: got.append(fr), device_frames=True
    )
    rdr.decode(data)
    assert got and all(isinstance(fr, jax.Array) for fr in got)
    out = np.concatenate([np.asarray(fr).astype(np.uint16) for fr in got])
    np.testing.assert_array_equal(out.reshape(-1, 32, 32), frames)


def test_upload_cache_shared_staging():
    """A shared upload_cache stages batch uploads by content hash: decoding
    the same bytes through two hub streams (multicast serving) populates the
    cache once and both streams decode exactly."""
    from fpv_tpu.api.multistream import MultiStreamDecoder

    frames = testdata.plasma_frames(6, 32, 32, seed=9)
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=2, chunk_log2=8)

    stage: dict = {}
    got: dict[str, list] = {"a": [], "b": []}
    hub = MultiStreamDecoder(
        sink=lambda sid, fr, ts: got[sid].append(np.asarray(fr)),
        device_frames=True, upload_cache=stage,
    )
    hub.add_stream("a")
    hub.add_stream("b")
    hub.feed("a", data)
    n_after_first = len(stage)
    hub.feed("b", data)
    hub.close()
    if n_after_first:  # fused path ran: stream b re-used stream a's staging
        assert len(stage) == n_after_first
        # streaming entries are keyed by section-bytes hash (the parse-skip
        # fast path), not by built-array content
        assert all(
            isinstance(k, tuple) and k[0] == "sec" for k in stage
        ), list(stage)
    want = _leftaligned(frames, 4)
    for sid in ("a", "b"):
        out = np.concatenate(got[sid]).astype(np.uint16).reshape(-1, 32, 32)
        np.testing.assert_array_equal(out, want)


def test_upload_cache_content_id():
    """Caller-declared content_id replaces section hashing: streams fed the
    same bytes under one id share staged uploads (keys carry the id, not a
    hash) and decode exactly."""
    from fpv_tpu.api.multistream import MultiStreamDecoder

    frames = testdata.plasma_frames(6, 32, 32, seed=9)
    data = encode_file_fpvt(frames, shift=4, frames_per_batch=2, chunk_log2=8)

    stage: dict = {}
    got: dict[str, list] = {"a": [], "b": []}
    hub = MultiStreamDecoder(
        sink=lambda sid, fr, ts: got[sid].append(np.asarray(fr)),
        device_frames=True, upload_cache=stage,
    )
    hub.add_stream("a", content_id="blob-1")
    hub.add_stream("b", content_id="blob-1")
    hub.feed("a", data)
    n_after_first = len(stage)
    hub.feed("b", data)
    hub.close()
    if n_after_first:  # fused path ran
        assert len(stage) == n_after_first
        assert all(k[0] == "cid" and k[1] == "blob-1" for k in stage), (
            list(stage)
        )
    want = _leftaligned(frames, 4)
    for sid in ("a", "b"):
        out = np.concatenate(got[sid]).astype(np.uint16).reshape(-1, 32, 32)
        np.testing.assert_array_equal(out, want)
