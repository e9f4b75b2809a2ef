"""rANS engines: tables, numpy/GPU-kernel bit-equivalence."""

import numpy as np
import pytest

from fpv_tpu.entropy.plane_codec import (
    decode_plane_batch,
    encode_plane_batch,
)
from fpv_tpu.entropy.tables import PROB_SCALE, normalize_freqs
from fpv_tpu.ops import rans_numpy as rn
from fpv_tpu.ops.rans_layout import BLOCK_LANES, chunk_lens
from fpv_tpu.utils import testdata


def test_normalize_freqs_properties():
    rng = np.random.default_rng(11)
    for _ in range(20):
        hist = rng.integers(0, 10000, size=256)
        hist[rng.integers(0, 256, size=100)] = 0
        if hist.sum() == 0:
            hist[0] = 1
        freq = normalize_freqs(hist)
        assert freq.sum() == PROB_SCALE
        assert np.all((freq > 0) == (hist > 0))


def test_normalize_freqs_floor_mask():
    """floor_mask floors only masked symbols; absent ones get freq 0."""
    rng = np.random.default_rng(12)
    hist = np.zeros(256, np.int64)
    hist[10:20] = rng.integers(1, 1000, size=10)
    mask = np.zeros(256, bool)
    mask[8:24] = True  # support superset
    freq = normalize_freqs(hist, ensure_all=True, floor_mask=mask)
    assert freq.sum() == PROB_SCALE
    assert np.all(freq[~mask] == 0)
    assert np.all(freq[mask] >= 1)
    # reclaimed floor mass: masked table must beat the blanket floor on
    # the coded cost of the histogrammed symbols
    freq_all = normalize_freqs(hist, ensure_all=True)
    p = hist / hist.sum()
    cost = lambda f: -(p[hist > 0] * np.log2(f[hist > 0] / PROB_SCALE)).sum()
    assert cost(freq) < cost(freq_all)


def test_support_mask_device_superset():
    """_support_mask is always a superset of the true support, and tight
    for mod-256 residual clusters (which straddle 0/255)."""
    import jax.numpy as jnp

    from fpv_tpu.api.fpvt_codec import _support_mask

    rng = np.random.default_rng(13)
    cases = [
        (rng.laplace(0, 3, size=(2, 64, 64)).astype(np.int64) % 256),  # wrap
        rng.integers(100, 140, size=(2, 64, 64)),  # plain interval
        rng.integers(0, 256, size=(2, 64, 64)),  # full range
        np.full((1, 8, 8), 7),  # constant
    ]
    for vals in cases:
        plane = jnp.asarray(vals.astype(np.uint8))
        mask = np.asarray(_support_mask(plane)).astype(bool)
        support = np.bincount(vals.astype(np.uint8).reshape(-1),
                              minlength=256) > 0
        assert np.all(mask[support]), "mask must cover every present symbol"
    # tightness on the wraparound cluster: no more than the contiguous run
    vals = (rng.laplace(0, 3, size=(4, 64, 64)).astype(np.int64) % 256)
    plane = jnp.asarray(vals.astype(np.uint8))
    mask = np.asarray(_support_mask(plane)).astype(bool)
    assert mask.sum() < 80  # cluster spans far less than 256


def test_normalize_freqs_device_masked():
    """Device normalizer: valid masked tables; legacy path unchanged."""
    import jax.numpy as jnp

    from fpv_tpu.entropy.tables_device import normalize_freqs_device

    rng = np.random.default_rng(15)
    hist = np.zeros(256, np.int64)
    hist[30:45] = rng.integers(1, 5000, size=15)
    mask = np.zeros(256, np.int32)
    mask[28:50] = 1
    freq = np.asarray(
        normalize_freqs_device(jnp.asarray(hist), jnp.asarray(mask))
    )
    assert freq.sum() == PROB_SCALE
    assert np.all(freq[mask == 0] == 0)
    assert np.all(freq[mask == 1] >= 1)
    # no-mask call still sums exactly and floors everything
    freq_all = np.asarray(normalize_freqs_device(jnp.asarray(hist)))
    assert freq_all.sum() == PROB_SCALE
    assert np.all(freq_all >= 1)


def test_fused_decode_tables_device_matches_host():
    """Device fused-table builder (integer gathers) == host builder, for
    both dense and narrow-support freq tables."""
    import jax.numpy as jnp

    from fpv_tpu.entropy.tables_device import (
        fused_decode_tables_device,
        normalize_freqs_device,
    )
    from fpv_tpu.ops import rans_triton as rt

    rng = np.random.default_rng(21)
    hists = [
        rng.integers(0, 1000, size=256),
        np.r_[rng.integers(1, 50, size=16), np.zeros(240, np.int64)],
    ]
    for hist in hists:
        freq = np.asarray(normalize_freqs_device(jnp.asarray(hist)))
        dev = np.asarray(fused_decode_tables_device(jnp.asarray(freq)))
        host = rt.fused_table(freq)
        assert dev.dtype == host.dtype and dev.shape == host.shape
        assert np.array_equal(dev, host)


@pytest.mark.parametrize("big", [2049, 3000, 4095, 4096])
def test_fused_decode_tables_device_entries_above_2048(big):
    """Frequencies and cumulative offsets above 2**11 (where a TF32 matmul
    would round) come out exact from the integer-gather builder."""
    import jax.numpy as jnp

    from fpv_tpu.entropy.tables_device import fused_decode_tables_device
    from fpv_tpu.ops import rans_triton as rt

    rest = PROB_SCALE - big
    freq = np.zeros(256, np.uint32)
    freq[[3, 200, 250]] = [rest // 2, big, rest - rest // 2]
    dev = np.asarray(fused_decode_tables_device(jnp.asarray(freq)))
    np.testing.assert_array_equal(dev, rt.fused_table(freq))
    f1 = (dev >> 8) & 0xFFF
    assert f1.max() == max(freq) - 1


def test_masked_tables_roundtrip_both_engines(monkeypatch):
    """Narrow-support plane + exact mask: encode/decode on both engines."""
    rng = np.random.default_rng(14)
    vals = (rng.laplace(0, 2, size=(3, 48, 128)).astype(np.int64) % 256)
    planes = vals.astype(np.uint8)
    hist = np.bincount(planes.reshape(-1), minlength=256)
    # sampled-looking hist (drop some counts) + exact mask
    hist_s = hist.copy()
    hist_s[hist_s == 1] = 0
    mask = hist > 0
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    for engine in ("numpy", "interpret"):
        b = planes.shape[0]
        stream = encode_plane_batch(
            planes.reshape(b, -1), hist_s, chunk_len=64, engine=engine,
            mask=mask,
        )
        assert np.all(stream.freq[~mask] == 0)
        out = np.asarray(decode_plane_batch(stream, engine=engine))
        np.testing.assert_array_equal(out, planes.reshape(b, -1))


def _roundtrip(planes: np.ndarray, chunk_len=128, engine="numpy"):
    b = planes.shape[0]
    hist = np.bincount(planes.reshape(-1), minlength=256)
    stream = encode_plane_batch(
        planes.reshape(b, -1), hist, chunk_len=chunk_len, engine=engine
    )
    out = np.asarray(decode_plane_batch(stream, engine=engine))
    np.testing.assert_array_equal(out, planes.reshape(b, -1))
    return stream


@pytest.mark.parametrize(
    "gen",
    [
        lambda: (testdata.plasma_frames(4, 48, 64) >> 8).astype(np.uint8),
        lambda: (testdata.noise_frames(3, 32, 48) & 0xFF).astype(np.uint8),
        lambda: np.full((2, 40, 40), 7, dtype=np.uint8),
        lambda: (testdata.plasma_frames(2, 31, 37) >> 8).astype(np.uint8),
    ],
)
def test_numpy_engine_roundtrip(gen):
    _roundtrip(gen())


def test_rans_ratio_reasonable_vs_entropy():
    """Coded size should be within a few % of the order-0 entropy bound.

    Uses a plane large enough to amortize the per-block lane states (the
    1024-way interleave costs 4 KB of states per 512K-symbol block; tiny
    planes pay proportionally more — a documented tradeoff for the
    transpose-free device layout).
    """
    planes = (testdata.plasma_frames(16, 256, 256) >> 8).astype(np.uint8)
    hist = np.bincount(planes.reshape(-1), minlength=256).astype(np.float64)
    p = hist[hist > 0] / hist.sum()
    h_bits = -(p * np.log2(p)).sum() * planes.size
    stream = encode_plane_batch(
        planes.reshape(16, -1), hist.astype(np.int64), chunk_len=512,
        engine="numpy",
    )
    coded_bits = stream.payload.size * 16 + stream.num_chunks * 32
    assert coded_bits < h_bits * 1.08 + 64 * 8


def test_corrupt_stream_detected():
    planes = (testdata.plasma_frames(2, 32, 32) >> 8).astype(np.uint8)
    hist = np.bincount(planes.reshape(-1), minlength=256)
    stream = encode_plane_batch(planes.reshape(2, -1), hist, chunk_len=128,
                                engine="numpy")
    assert stream.payload.size
    stream.payload[0] ^= 0x5A
    with pytest.raises(ValueError):
        decode_plane_batch(stream, engine="numpy")


def _kernel_encode(symbols, lens, table, k, prob_bits=12, ctx=False):
    """rans_triton.encode (interpreted) on host-interleaved [C, K] symbols
    -> (states, counts, compact payload)."""
    import jax.numpy as jnp

    from fpv_tpu.ops import rans_triton as rt

    nb = len(lens) // BLOCK_LANES
    syms = symbols.reshape(nb, BLOCK_LANES, k).transpose(0, 2, 1)
    st, words, cnts = rt.encode(
        jnp.asarray(syms.astype(np.uint8)), jnp.asarray(lens),
        jnp.asarray(table), k, prob_bits=prob_bits, ctx_mode=ctx,
        interpret=True,
    )
    cn = np.asarray(cnts)
    w = np.asarray(words)
    pay = np.concatenate([w[g, : cn[g]] for g in range(len(cn))])
    return np.asarray(st).reshape(-1), cn, pay.astype(np.uint16)


def _kernel_decode(states, counts, payload, lens, table, k, prob_bits=12,
                   ctx=False):
    """rans_triton.decode (interpreted) -> ([C, K] symbols, ok [C])."""
    import jax.numpy as jnp

    from fpv_tpu.ops import rans_triton as rt

    nb = len(lens) // BLOCK_LANES
    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    out, ok = rt.decode(
        jnp.asarray(counts), jnp.asarray(starts), jnp.asarray(payload),
        jnp.asarray(states.reshape(nb, BLOCK_LANES)), jnp.asarray(lens),
        jnp.asarray(table), k, prob_bits=prob_bits, ctx_mode=ctx,
        interpret=True,
    )
    syms = np.asarray(out).transpose(0, 2, 1).reshape(-1, k)
    return syms, np.asarray(ok).reshape(-1)


def _order0_case(rng, B, S, K):
    from fpv_tpu.entropy.plane_codec import _interleave_np

    data = rng.normal(100, 25, size=(B, S)).astype(np.uint8)
    lens = chunk_lens(B, S, K)
    symbols = _interleave_np(data, K, len(lens) // BLOCK_LANES)
    freq = normalize_freqs(np.bincount(data.reshape(-1), minlength=256))
    return symbols, lens, freq


def _ctx_case(seed, K):
    from fpv_tpu.entropy.plane_codec import _interleave_np
    from fpv_tpu.entropy.tables import normalize_freqs_ctx

    frames = testdata.plasma_frames(2, 40, 64, bits=12, seed=seed)
    plane = ((frames << 4) & 0xF0).astype(np.uint8).reshape(2, -1)
    lens = chunk_lens(2, plane.shape[1], K)
    nb = len(lens) // BLOCK_LANES
    sym4 = (_interleave_np(plane, K, nb) >> 4).astype(np.uint8)
    idx = rn.encode_ctx_indices(sym4, lens)
    mask = np.arange(K)[None, :] < lens[:, None]
    hist = np.bincount(idx[mask].reshape(-1), minlength=512)
    freq = normalize_freqs_ctx(hist)
    return sym4, idx, lens, mask, freq


def test_pallas_kernels_match_numpy_engine():
    """Bit-exact equivalence of the GPU kernels (interpret mode) vs the
    numpy engine: states, block counts, payload, decode output."""
    from fpv_tpu.ops import rans_triton as rt

    symbols, lens, freq = _order0_case(np.random.default_rng(0), 3, 700, 64)
    states, counts, payload = rn.encode_blocks(symbols, lens, freq)
    st, cn, pay = _kernel_encode(symbols, lens, rt.encode_table(freq), 64)
    np.testing.assert_array_equal(cn, counts.astype(cn.dtype))
    np.testing.assert_array_equal(st, states)
    np.testing.assert_array_equal(pay, payload)

    out, ok = _kernel_decode(
        states, counts, payload, lens, rt.fused_table(freq), 64
    )
    assert ok.all()
    mask = np.arange(64)[None, :] < lens[:, None]
    np.testing.assert_array_equal(out[mask], symbols[mask])


def test_fused_table_decode_matches():
    """The fused decode table (one entry per slot: off, f-1, sym) holds
    exactly what the numpy engine derives per slot, and decoding through
    it is bit-exact vs the numpy decoder on the same stream."""
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import PROB_BITS

    symbols, lens, freq = _order0_case(np.random.default_rng(3), 2, 900, 64)
    states, counts, payload = rn.encode_blocks(symbols, lens, freq)
    fused = rt.fused_table(freq)
    assert fused.shape == (PROB_SCALE,)
    sym = fused & 0xFF
    np.testing.assert_array_equal(
        sym, np.repeat(np.arange(256), freq.astype(np.int64))
    )
    np.testing.assert_array_equal(((fused >> 8) & 0xFFF) + 1, freq[sym])
    cum = np.concatenate([[0], np.cumsum(freq)[:-1]])
    np.testing.assert_array_equal(
        fused >> (8 + PROB_BITS), np.arange(PROB_SCALE) - cum[sym]
    )
    out, ok = _kernel_decode(states, counts, payload, lens, fused, 64)
    ref, ok_ref = rn.decode_blocks(states, counts, payload, lens, freq, 64)
    assert ok.all() and ok_ref.all()
    mask = np.arange(64)[None, :] < lens[:, None]
    np.testing.assert_array_equal(out[mask], ref[mask])


def test_ctx_fused_table_decode_matches():
    """The ctx fused decode table decodes bit-exactly vs the numpy ctx
    decoder on the same stream."""
    from fpv_tpu.ops import rans_triton as rt

    K = 32
    sym4, idx, lens, mask, freq = _ctx_case(9, K)
    _f32, cum, _sos = rn.ctx_tables(freq)
    states, counts, payload = rn.encode_blocks(
        idx, lens, freq, prob_bits=7, cum=cum
    )
    fused = rt.ctx_fused_table(freq)
    assert fused.shape == (PROB_SCALE,)
    out, ok = _kernel_decode(
        states, counts, payload, lens, fused, K, prob_bits=7, ctx=True
    )
    ref, ok_ref = rn.decode_blocks_ctx(states, counts, payload, lens, freq, K)
    assert ok.all() and ok_ref.all()
    np.testing.assert_array_equal(out[mask], ref[mask])
    np.testing.assert_array_equal(out[mask], sym4[mask])


def test_segmented_chunks_kernel_matches_numpy():
    """chunk_len > SEG_LEN: the kernels (state carried across segments,
    word pointer restarted per segment) are bit-exact vs the numpy engine,
    and roundtrip."""
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import SEG_LEN, num_segments

    K = 2 * SEG_LEN
    assert num_segments(K) == 2
    symbols, lens, freq = _order0_case(np.random.default_rng(5), 2, 600_000, K)
    nblocks = len(lens) // BLOCK_LANES
    states, counts, payload = rn.encode_blocks(symbols, lens, freq)
    assert len(counts) == nblocks * 2
    st, cn, pay = _kernel_encode(symbols, lens, rt.encode_table(freq), K)
    np.testing.assert_array_equal(cn, counts.astype(cn.dtype))
    np.testing.assert_array_equal(st, states)
    np.testing.assert_array_equal(pay, payload)
    out, ok = _kernel_decode(
        states, counts, payload, lens, rt.fused_table(freq), K
    )
    assert ok.all()
    mask = np.arange(K)[None, :] < lens[:, None]
    np.testing.assert_array_equal(out[mask], symbols[mask])


def test_segmented_chunks_plane_roundtrip_both_engines(monkeypatch):
    """Long chunks through the public plane codec, both engines, both
    codings — fewer stored states, same pixels."""
    from fpv_tpu.ops.rans_layout import CODING_CTX16, SEG_LEN

    rng = np.random.default_rng(6)
    B, K = 2, 2 * SEG_LEN
    planes = rng.normal(120, 12, size=(B, 1200, 1024)).astype(np.uint8)
    hist = np.bincount(planes.reshape(-1), minlength=256)
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    for engine in ("numpy", "interpret"):
        stream = encode_plane_batch(
            planes.reshape(B, -1), hist, chunk_len=K, engine=engine
        )
        out = np.asarray(decode_plane_batch(stream, engine=engine))
        np.testing.assert_array_equal(out, planes.reshape(B, -1))
    # ctx coding (nibble data: bottom nibble zero)
    nib = (planes & 0xF0).astype(np.uint8)
    for engine in ("numpy", "interpret"):
        stream = encode_plane_batch(
            nib.reshape(B, -1), None, chunk_len=K, engine=engine,
            coding=CODING_CTX16,
        )
        out = np.asarray(decode_plane_batch(stream, engine=engine))
        np.testing.assert_array_equal(out, nib.reshape(B, -1))


def test_ctx_mode_numpy_roundtrip_and_gain():
    """Context-coded low-plane mode (coding=1): numpy engine roundtrips and
    beats the order-0 entropy on correlated nibble data."""
    from fpv_tpu.entropy.plane_codec import _interleave_np
    from fpv_tpu.entropy.tables import normalize_freqs_ctx

    frames = testdata.plasma_frames(3, 48, 100, bits=12, seed=2)
    plane = ((frames << 4) & 0xF0).astype(np.uint8).reshape(3, -1)
    K = 64
    lens = chunk_lens(3, plane.shape[1], K)
    nb = len(lens) // BLOCK_LANES
    sym4 = (_interleave_np(plane, K, nb) >> 4).astype(np.uint8)
    idx = rn.encode_ctx_indices(sym4, lens)
    mask = np.arange(K)[None, :] < lens[:, None]
    hist = np.bincount(idx[mask].reshape(-1), minlength=512)
    freq = normalize_freqs_ctx(hist)
    _f32, cum, _sos = rn.ctx_tables(freq)
    states, counts, payload = rn.encode_blocks(
        idx, lens, freq, prob_bits=7, cum=cum
    )
    out, ok = rn.decode_blocks_ctx(states, counts, payload, lens, freq, K)
    assert ok.all()
    np.testing.assert_array_equal(out[mask], sym4[mask])


def test_ctx_mode_pallas_matches_numpy():
    """Ctx-mode GPU kernels (interpret) are bit-exact vs the numpy ctx
    engine: states, counts, payload, and decoded symbols."""
    from fpv_tpu.ops import rans_triton as rt

    K = 32
    sym4, idx, lens, mask, freq = _ctx_case(4, K)
    _f32, cum, _sos = rn.ctx_tables(freq)
    states, counts, payload = rn.encode_blocks(
        idx, lens, freq, prob_bits=7, cum=cum
    )
    # the kernel takes nibble symbols and forms ctx*16+sym itself
    st, cn, pay = _kernel_encode(
        sym4, lens, rt.ctx_encode_table(freq), K, prob_bits=7, ctx=True
    )
    np.testing.assert_array_equal(cn, counts.astype(cn.dtype))
    np.testing.assert_array_equal(st, states)
    np.testing.assert_array_equal(pay, payload)
    out, ok = _kernel_decode(
        states, counts, payload, lens, rt.ctx_fused_table(freq), K,
        prob_bits=7, ctx=True,
    )
    assert ok.all()
    np.testing.assert_array_equal(out[mask], sym4[mask])


def test_plane_codec_pallas_interpret_path(monkeypatch):
    """encode/decode_plane_batch on the device engine, kernels interpreted
    on request; the numpy engine decodes what the kernels encoded."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "interpret")
    planes = (testdata.plasma_frames(2, 16, 40) >> 8).astype(np.uint8)
    hist = np.bincount(planes.reshape(-1), minlength=256)
    stream = encode_plane_batch(planes.reshape(2, -1), hist, chunk_len=64)
    out = decode_plane_batch(stream, engine="numpy")
    np.testing.assert_array_equal(np.asarray(out), planes.reshape(2, -1))
    out2 = decode_plane_batch(stream, engine="interpret")
    np.testing.assert_array_equal(np.asarray(out2), planes.reshape(2, -1))


@pytest.mark.parametrize("ctx", [False, True])
def test_kernel_partial_blocks_and_empty_lanes(ctx):
    """A last block whose lanes stop at different steps, and a block with
    only zero-length lanes, encode and decode bit-exactly (interpreted)."""
    from fpv_tpu.ops import rans_triton as rt

    rng = np.random.default_rng(31)
    K = 16
    n = BLOCK_LANES * K + 333  # block 1 is partial: lanes of 1 or 0 steps
    lens = chunk_lens(1, n, K)
    lens = np.concatenate([lens, np.zeros(BLOCK_LANES, np.int32)])
    assert lens[BLOCK_LANES] == 1 and lens[-1] == 0
    nb = len(lens) // BLOCK_LANES
    mask = np.arange(K)[None, :] < lens[:, None]
    if ctx:
        sym4 = np.where(mask, rng.integers(0, 16, (nb * BLOCK_LANES, K)), 0)
        sym4 = sym4.astype(np.uint8)
        idx = rn.encode_ctx_indices(sym4, lens)
        from fpv_tpu.entropy.tables import normalize_freqs_ctx

        freq = normalize_freqs_ctx(np.bincount(idx[mask], minlength=512))
        _f, cum, _s = rn.ctx_tables(freq)
        ref = rn.encode_blocks(idx, lens, freq, prob_bits=7, cum=cum)
        got = _kernel_encode(
            sym4, lens, rt.ctx_encode_table(freq), K, prob_bits=7, ctx=True
        )
        table, symbols = rt.ctx_fused_table(freq), sym4
    else:
        symbols = np.where(mask, rng.integers(0, 40, (nb * BLOCK_LANES, K)), 0)
        symbols = symbols.astype(np.uint8)
        freq = normalize_freqs(np.bincount(symbols[mask], minlength=256))
        ref = rn.encode_blocks(symbols, lens, freq)
        got = _kernel_encode(symbols, lens, rt.encode_table(freq), K)
        table = rt.fused_table(freq)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.astype(g.dtype))
    assert got[1][-1] == 0  # the empty block emits no words
    out, ok = _kernel_decode(
        *ref, lens, table, K, prob_bits=7 if ctx else 12, ctx=ctx
    )
    assert ok.all()
    np.testing.assert_array_equal(out[mask], symbols[mask])


def test_kernels_refuse_cpu_without_request(monkeypatch):
    """On a CPU the device engine is never chosen on its own, and asking
    for a kernel without the interpret request is an error."""
    from fpv_tpu import backend

    monkeypatch.delenv("FPV_TPU_RANS_ENGINE", raising=False)
    assert backend.engine() == "numpy"
    planes = np.zeros((1, 64), np.uint8)
    planes[0, ::3] = 9
    hist = np.bincount(planes.reshape(-1), minlength=256)
    with pytest.raises(RuntimeError, match="interpret"):
        encode_plane_batch(planes, hist, chunk_len=16, engine="gpu")
