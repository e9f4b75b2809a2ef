"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The sharded programs are the device path, so every test here asks for the
GPU kernels in the Pallas interpreter."""

import jax
import numpy as np
import pytest

from fpv_tpu.parallel import mesh as pmesh


@pytest.fixture(autouse=True)
def _interpret_engine(monkeypatch):
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")


def test_device_count():
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"


@pytest.mark.parametrize("n", [2, 4, 8])
def test_multichip_dryrun(n):
    pmesh.multichip_dryrun(n)


@pytest.mark.parametrize("sharded", [True, False])
def test_per_device_pieces(sharded):
    """_per_device: a P('data') array yields its own shards, one device
    each, in device order; anything else is sliced."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = pmesh.make_mesh(4, data=4)
    x = np.arange(24 * 3, dtype=np.int32).reshape(24, 3)
    a = jax.device_put(x, NamedSharding(mesh, P("data"))) if sharded else x
    pieces = pmesh._per_device(a, 4)
    for d, piece in enumerate(pieces):
        np.testing.assert_array_equal(np.asarray(piece), x[6 * d : 6 * (d + 1)])
        if sharded:
            assert piece.devices() == {mesh.devices.flat[d]}


def test_sharded_model_step_matches_single_device():
    from fpv_tpu.api.fpvt_codec import encode_model_step
    from fpv_tpu.utils import testdata

    frames = testdata.plasma_frames(8, 32, 32, bits=12)
    delta = frames[0]
    dh = np.asarray(((delta.astype(np.uint16) << 4) >> 8)).astype(np.uint8)
    dl = np.asarray((delta.astype(np.uint16) << 4) & 0xFF).astype(np.uint8)

    m = pmesh.make_mesh(4, data=4, space=1)
    step = pmesh.sharded_encode_model_step(m, shift=4)
    out_sharded = step(pmesh.shard_frames(frames, m), dh, dl)
    out_single = encode_model_step(
        jax.numpy.asarray(frames), jax.numpy.asarray(dh), jax.numpy.asarray(dl),
        4, False,
    )
    for k in ("high", "low", "preview", "hist_high"):
        np.testing.assert_array_equal(np.asarray(out_sharded[k]),
                                      np.asarray(out_single[k]))
    np.testing.assert_array_equal(np.asarray(out_sharded["use_delta"]),
                                  np.asarray(out_single["use_delta"]))


def test_sharded_model_step_space_axis():
    """Rows sharded over 'space' (large-frame mode): GSPMD must insert the
    halo exchanges the predictors' row rolls and the preview box filter
    need across row shards — outputs stay identical to single-device."""
    from fpv_tpu.api.fpvt_codec import encode_model_step
    from fpv_tpu.utils import testdata

    frames = testdata.plasma_frames(4, 64, 32, bits=12)
    delta = frames[0]
    dh = np.asarray(((delta.astype(np.uint16) << 4) >> 8)).astype(np.uint8)
    dl = np.asarray((delta.astype(np.uint16) << 4) & 0xFF).astype(np.uint8)

    m = pmesh.make_mesh(4, data=2, space=2)
    step = pmesh.sharded_encode_model_step(m, shift=4)
    out_sharded = step(pmesh.shard_frames(frames, m), dh, dl)
    out_single = encode_model_step(
        jax.numpy.asarray(frames), jax.numpy.asarray(dh), jax.numpy.asarray(dl),
        4, False,
    )
    for k in ("high", "low", "preview", "hist_high", "mask_high", "spatial"):
        np.testing.assert_array_equal(np.asarray(out_sharded[k]),
                                      np.asarray(out_single[k]))


def test_sharded_fused_encode_bitexact_vs_single_device():
    """shard_map of the production fused encode program produces streams
    bit-identical to encoding each device's frame slice on one device."""
    import jax.numpy as jnp

    from fpv_tpu.api.fpvt_codec import _small_layout, fused_encode_batch
    from fpv_tpu.utils import testdata

    D, H, W, K = 4, 16, 16, 16
    m = pmesh.make_mesh(D, data=D)
    frames = testdata.plasma_frames(8, H, W, bits=12)
    delta = frames[0]
    dh = (delta >> 8).astype(np.uint8)
    dl = (delta & 0xFF).astype(np.uint8)
    f = pmesh.sharded_fused_encode(m, chunk_len=K)
    outs = f(pmesh.shard_frames(frames, m), jnp.asarray(dh), jnp.asarray(dl))
    small_g, st_g, ph_g, pl_g, pv_g = (np.asarray(x) for x in outs)
    bl = frames.shape[0] // D
    lay = _small_layout(bl, H, W, K)
    L = small_g.size // D
    SL = st_g.size // D
    for d in range(D):
        ref = fused_encode_batch(
            jnp.asarray(frames[d * bl : (d + 1) * bl]),
            jnp.asarray(dh), jnp.asarray(dl), 0, False, K,
        )
        rs, rst, rh, rl, rpv = (np.asarray(x) for x in ref)
        s_d = small_g[d * L : (d + 1) * L]
        np.testing.assert_array_equal(s_d, rs)
        np.testing.assert_array_equal(st_g[d * SL : (d + 1) * SL], rst)
        for glob, ref_pay, name in (
            (ph_g, rh, "high"), (pl_g, rl, "low"), (pv_g, rpv, "preview")
        ):
            lo, hi = lay[f"counts_{name}"]
            total = int(s_d[lo:hi].sum())
            n = ref_pay.size
            np.testing.assert_array_equal(
                glob[d * n : d * n + total], ref_pay[:total]
            )


def test_sharded_codec_roundtrip_lossless():
    """The full codec (rANS kernels included) over a 4-device mesh."""
    import jax.numpy as jnp

    from fpv_tpu.utils import testdata

    m = pmesh.make_mesh(4, data=4)
    frames = testdata.plasma_frames(8, 16, 16, bits=16)
    dh = (frames[0] >> 8).astype(np.uint8)
    dl = (frames[0] & 0xFF).astype(np.uint8)
    step = pmesh.sharded_codec_roundtrip(m, chunk_len=16)
    out, ok = step(pmesh.shard_frames(frames, m), jnp.asarray(dh), jnp.asarray(dl))
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(out), frames)


def test_sharded_decode_file_mixed_sections(monkeypatch):
    """sharded_decode_file over a file mixing device-geometry sections
    (grouped by decode signature, full mesh groups decode as one sharded
    program), CODING_CONST sections (their own signature group), and a
    narrow host-coded section (leftover fallback) — pixel-exact against
    the single-device reader, file order preserved."""
    from fpv_tpu.api.fpvt_codec import FpvtWriter, decode_file_fpvt
    from fpv_tpu.format import fpvt as _fpvt
    from fpv_tpu.utils import testdata

    monkeypatch.setenv("FPV_TPU_RAW", "0")  # keep tiny sections rANS-coded
    D, h, w, bpb, shift = 2, 32, 32, 2, 4
    m = pmesh.make_mesh(D, data=D)
    rng = np.random.default_rng(7)
    wtr = FpvtWriter(w, h, shift=shift, frames_per_batch=bpb, chunk_log2=5)
    base = testdata.plasma_frames(1, h, w, bits=12)[0]
    parts = [wtr.init(base)]
    frames = []

    def add_fused(sub):
        # _encode_batch_fused directly: the public encode path routes small
        # batches to narrow host-coded streams, but this test needs
        # device-geometry sections for the sharded fused decode
        flags, (hs, ls, pvs) = wtr._encode_batch_fused(
            wtr._put(sub), sub.shape[0]
        )
        sec = _fpvt.serialize_batch_section(
            flags, np.full(sub.shape[0], -1, np.int64), hs, ls, pvs
        )
        parts.append(wtr.add_batch(sec, sub.shape[0]))
        frames.append(sub)

    for _ in range(2 * D):  # two full mesh groups of noise sections
        add_fused(rng.integers(0, 1 << 12, size=(bpb, h, w), dtype=np.uint16))
    for _ in range(D):  # repeated delta frame -> CODING_CONST planes
        add_fused(np.broadcast_to(base, (bpb, h, w)).copy())
    sub = rng.integers(0, 1 << 12, size=(bpb, h, w), dtype=np.uint16)
    parts.append(wtr.encode_batch(sub))  # narrow section -> leftover path
    frames.append(sub)
    parts.append(wtr.finish())
    data = b"".join(parts)

    out = pmesh.sharded_decode_file(data, m)
    want = (np.concatenate(frames).astype(np.uint32) << shift).astype(
        np.uint16
    )
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, decode_file_fpvt(data))

    # previews decode inside the same sharded programs and match the
    # single-device reader batch by batch
    from fpv_tpu.api.fpvt_codec import FpvtReader

    out2, pv = pmesh.sharded_decode_file(data, m, want_previews=True)
    np.testing.assert_array_equal(out2, want)
    rdr = FpvtReader(data)
    pv_want = np.concatenate(
        [rdr.decode_batch_with_previews(i)[1] for i in range(rdr.num_batches)]
    )
    np.testing.assert_array_equal(pv, pv_want)


def test_sharded_encode_file_byte_identical(monkeypatch):
    """sharded_encode_file produces byte-identical files to the single-device
    encode_file_fpvt (with the fused device path pinned on both sides), and
    the result decodes losslessly.  Covers grouped full batches AND the tail
    batch fallback."""
    from fpv_tpu.api.fpvt_codec import decode_file_fpvt, encode_file_fpvt
    from fpv_tpu.utils import testdata

    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    # keep streams CODED at these tiny sizes (raw-store parity has its own
    # test: test_raw.test_sharded_encode_raw_byte_identical)
    monkeypatch.setenv("FPV_TPU_RAW", "0")
    D, h, w, bpb = 2, 16, 16, 2
    m = pmesh.make_mesh(D, data=D)
    n = 1 + 2 * D * bpb + bpb  # delta frame + 2 mesh groups + tail batch
    frames = testdata.plasma_frames(n, h, w, bits=12)
    ts = 1000 + np.arange(n, dtype=np.int64)
    kwargs = dict(shift=4, frames_per_batch=bpb, chunk_log2=4, timestamps=ts)
    got = pmesh.sharded_encode_file(frames, m, **kwargs)
    want = encode_file_fpvt(frames, **kwargs)
    assert got == want
    out = decode_file_fpvt(got)
    np.testing.assert_array_equal(
        out, (frames.astype(np.uint32) << 4).astype(np.uint16)
    )
    # timestamps rode along (frame 0's is dropped with the delta frame)
    from fpv_tpu.api.fpvt_codec import FpvtReader

    rdr = FpvtReader(got)
    got_ts = np.concatenate(
        [rdr.timestamps(i) for i in range(rdr.num_batches)]
    )
    np.testing.assert_array_equal(got_ts, ts[1:])


def test_graft_entry():
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert "high" in out and out["high"].shape == args[0].shape
    ge.dryrun_multichip(4)
