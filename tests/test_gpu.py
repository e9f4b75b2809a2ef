"""Compiled GPU kernels against their plain references (needs a GPU).

Run on the card: ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
Elsewhere every test here skips (the ``gpu`` fixture decides at test time).
"""

import numpy as np
import pytest

from fpv_tpu.ops import rans_numpy as rn
from fpv_tpu.ops.rans_layout import BLOCK_LANES, SEG_LEN, chunk_lens
from fpv_tpu.utils import testdata

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k", [64, 2 * SEG_LEN])
@pytest.mark.parametrize("ctx", [False, True])
def test_rans_kernels_compiled_match_numpy(gpu, k, ctx):
    import jax.numpy as jnp

    from fpv_tpu.entropy.plane_codec import _interleave_np
    from fpv_tpu.entropy.tables import normalize_freqs, normalize_freqs_ctx
    from fpv_tpu.ops import rans_triton as rt

    frames = testdata.plasma_frames(3, 200, 300, bits=12, seed=5)
    plane = ((frames << 4) & (0xF0 if ctx else 0xFF)).astype(np.uint8)
    flat = plane.reshape(-1) >> (4 if ctx else 0)
    lens = chunk_lens(1, flat.size, k)
    nb = len(lens) // BLOCK_LANES
    il = _interleave_np(flat.reshape(1, -1), k, nb)
    if ctx:
        idx = rn.encode_ctx_indices(il, lens)
        m = np.arange(k)[None, :] < lens[:, None]
        freq = normalize_freqs_ctx(np.bincount(idx[m], minlength=512))
        _f, cum, _s = rn.ctx_tables(freq)
        ref = rn.encode_blocks(idx, lens, freq, prob_bits=7, cum=cum)
        enc_tab, dec_tab, pb = rt.ctx_encode_table(freq), rt.ctx_fused_table(freq), 7
    else:
        freq = normalize_freqs(np.bincount(flat, minlength=256))
        ref = rn.encode_blocks(il, lens, freq)
        enc_tab, dec_tab, pb = rt.encode_table(freq), rt.fused_table(freq), 12
    padded = np.zeros(nb * k * BLOCK_LANES, np.uint8)
    padded[: flat.size] = flat
    st, words, cnt = rt.encode(
        jnp.asarray(padded.reshape(nb, k, BLOCK_LANES)), jnp.asarray(lens),
        jnp.asarray(enc_tab), k, prob_bits=pb, ctx_mode=ctx,
    )
    cnt, words = np.asarray(cnt), np.asarray(words)
    pay = np.concatenate([words[g, : cnt[g]] for g in range(len(cnt))])
    np.testing.assert_array_equal(np.asarray(st).reshape(-1), ref[0])
    np.testing.assert_array_equal(cnt, ref[1].astype(cnt.dtype))
    np.testing.assert_array_equal(pay, ref[2])
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    out, ok = rt.decode(
        jnp.asarray(cnt), jnp.asarray(starts), jnp.asarray(ref[2]),
        jnp.asarray(ref[0].reshape(nb, BLOCK_LANES)), jnp.asarray(lens),
        jnp.asarray(dec_tab), k, prob_bits=pb, ctx_mode=ctx,
    )
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out).reshape(-1)[: flat.size], flat)


@pytest.mark.parametrize("shape", [(3, 100, 77), (2, 256, 512), (1, 1030, 9)])
def test_cg2d_kernel_compiled(gpu, shape):
    from fpv_tpu.models.predictors import cg2d_decode_np
    from fpv_tpu.ops import predict

    rng = np.random.default_rng(2)
    plane = rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    res = predict.cg2d_encode(plane)
    np.testing.assert_array_equal(np.asarray(predict.cg2d_decode(res)), plane)
    np.testing.assert_array_equal(cg2d_decode_np(np.asarray(res)), plane)


def test_writer_reader_device_path(gpu):
    from fpv_tpu import backend
    from fpv_tpu.api.fpvt_codec import FpvtReader, FpvtWriter

    assert backend.engine() == "gpu"
    frames = testdata.plasma_frames(17, 128, 160, bits=12, seed=3)
    w = FpvtWriter(160, 128, shift=4, frames_per_batch=8, narrow=False)
    data = w.init(frames[0])
    data += w.encode_batch(frames[1:9]) + w.encode_batch(frames[9:])
    data += w.finish()
    r = FpvtReader(data)
    want = frames[1:].astype(np.uint16) << 4
    got = np.concatenate([r.decode_batch(i) for i in range(r.num_batches)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(r.decode_frame(11), want[11])
