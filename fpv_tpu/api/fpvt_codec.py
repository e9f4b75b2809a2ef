"""FPVT batched codec: the device encode/decode pipeline.

Encode path per batch of frames (one fused jitted model step + three rANS
kernel launches):

    [B,H,W] u16 --split--> high/low planes --box--> previews
        --delta?--> --spatial?--> residual planes + per-frame flags
        --histogram--> tables --rANS--> chunk streams

Decisions (delta on/off; spatial predictor none/up/cg2d for main and preview)
are made per frame on device from sampled-histogram entropies — unlike the
compat path they don't need the reference's integer quirks, just a good
choice (the FPVT format stores the decision in frame flags).

Decode inverts: rANS -> inverse spatial (prefix-sum for 'up', anti-diagonal
wavefront for 'cg2d') -> delta add -> plane combine.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import struct

import jax
import jax.numpy as jnp
import numpy as np

from fpv_tpu.entropy.plane_codec import (
    PlaneStream,
    decode_plane_batch,
    encode_plane_batch,
)
from fpv_tpu.format import fpvt
from fpv_tpu.format.fpvt import (
    F_NO_LOW,
    F_PV_SPATIAL_SHIFT,
    F_SPATIAL_SHIFT,
    F_USE_DELTA,
    SPATIAL_CG2D,
    SPATIAL_UP,
    Header,
)
from fpv_tpu.ops.planes import combine_planes, split_planes
from fpv_tpu.ops.predict import (
    cg2d_decode,
    cg2d_encode,
    up_decode,
    up_encode,
)
from fpv_tpu.ops.preview import generate_preview

_DECISION_STRIDE = 16  # sampling stride for predictor decisions

# Hard per-batch size ceiling for the device codec: payload word offsets
# accumulate in int32 cumsums inside the fused programs (int64 would force
# jax_enable_x64), so one plane batch must stay below 2^31 symbols.  The
# format itself allows more (parse guard 16e9); batches beyond this raise
# instead of silently wrapping offsets.  (At 2 B/px a 2^31-symbol batch is
# ~4 GB of raw frames — beyond any sensible per-batch HBM budget anyway.)
MAX_DEVICE_SYMS = (1 << 31) - 1

# Preview streams code with their own (shorter) chunk length: a preview
# has 1/16 of a main plane's symbols, so at the header chunk a big-frame
# preview lands in very few — often ONE — rANS blocks and the decode
# kernel runs long per-chunk step loops at fractional cell occupancy
# (measured ~20 ms of a 124 ms 4x4096^2 batch decode).  The wire format
# has always carried chunk_len per stream (format/fpvt.py plane-stream
# header) and pre-change readers fall back to the per-plane decode path
# for such files, so this is encoder policy, not a format change.
PV_CHUNK_MAX = 512


def pv_chunk_len(chunk_len: int) -> int:
    """The chunk length preview streams are coded with."""
    return min(chunk_len, PV_CHUNK_MAX)
_HIST_STRIDE = 16  # sampling stride for rANS table histograms

# Prev-frame prediction anchor interval (encoder policy, not format): every
# PREV_ANCHOR-th frame of a batch may not use F_USE_PREV, so a single-frame
# random access decodes at most PREV_ANCHOR-1 extra frames.  Decoders accept
# arbitrary chains (bounded by the batch — chains never cross sections).
PREV_ANCHOR = 8


def _sample_rows(plane: jax.Array, stride: int) -> jax.Array:
    """Row-strided sample of a [B, H, W] plane — contiguous reads,
    spatially representative enough for decisions and table histograms."""
    if plane.ndim == 2:
        return plane[:, ::stride]
    return plane[:, ::stride, :]


def _sample_rows_rotating(plane: jax.Array, stride: int) -> jax.Array:
    """Row sample with a per-frame phase: frame i samples rows
    ``(i % stride) + stride*j``.

    A fixed phase lets adversarial content hide on the never-sampled rows
    and systematically flip per-frame decisions; rotating the phase bounds
    the damage to isolated frames (any single decision is still lossless —
    only its coded size suffers).  One batched row gather of 1/stride of
    the plane.
    """
    b, h, w = plane.shape
    nr = max(h // stride, 1)
    offs = jnp.arange(b, dtype=jnp.int32) % stride
    offs = jnp.minimum(offs, max(h - 1 - (nr - 1) * stride, 0))
    idx = offs[:, None] + stride * jnp.arange(nr, dtype=jnp.int32)[None, :]
    return jnp.take_along_axis(plane, idx[:, :, None], axis=1)


def _residual_cost(plane: jax.Array) -> jax.Array:
    """Per-frame predictor-choice proxy: sum of |signed residual| on samples.

    For near-Laplacian residuals, entropy is monotone in mean absolute
    residual, so comparing these costs picks the same predictor an entropy
    comparison would — with pure elementwise ops (no on-device scatters).
    """
    b = plane.shape[0]
    s = (
        _sample_rows_rotating(plane, _DECISION_STRIDE)
        .reshape(b, -1)
        .astype(jnp.int32)
    )
    mag = jnp.minimum(s, 256 - s)  # wraparound distance of the mod-256 residual
    # float32 accumulation: costs are only compared, and int32 would wrap on
    # 65536x65536-frame headers (worst case 128/px * 2^32/16 samples)
    return jnp.sum(mag.astype(jnp.float32), axis=1)


@jax.jit
def _residual_cost_exact(plane: jax.Array) -> jax.Array:
    """Exact (unsampled) wraparound-magnitude cost of a residual plane.

    Accumulates in float32 (the cost is only ever compared): headers allow
    65536x65536 frames and worst-case magnitude 128/px overflows int32
    beyond ~16.7M pixels."""
    s = plane.reshape(-1).astype(jnp.int32)
    return jnp.sum(jnp.minimum(s, 256 - s).astype(jnp.float32))


def _decode_delta_planes(dflags, dh_stream, dl_stream, h, w):
    """Decode the delta-section planes, inverting the high plane's spatial
    prediction recorded in dflags bits 1-2 (see FpvtWriter.init)."""
    dh = decode_plane_batch(dh_stream).reshape(1, h, w)
    spatial = (dflags >> F_SPATIAL_SHIFT) & 3
    if spatial == SPATIAL_UP:
        dh = up_decode(dh)
    elif spatial == SPATIAL_CG2D:
        dh = cg2d_decode(dh)
    if dl_stream is not None:
        dl = decode_plane_batch(dl_stream).reshape(h, w)
    else:
        dl = jnp.zeros((h, w), jnp.uint8)
    return dh.reshape(h, w), dl


def _exact_hist_256(plane: jax.Array) -> jax.Array:
    """[256] int32 EXACT (unsampled) byte histogram of a plane batch.

    Compare-and-sum reduce (the :func:`_batch_hist` pattern without the row
    sampling) — heavier per element than interval bounds (~256 fused
    compare+adds vs 2 ops) but exact, so ``hist > 0`` is the true support.
    Used for the preview plane: it is 1/16 of the pixels, and its values
    are structurally even ((sum/16) & 0xfe, fpv_tpu.ops.preview) — an
    interval mask would floor 128 never-occurring odd symbols, ~3% of
    table mass.  Sum-reductions only, so GSPMD can partition it (a custom
    bitwise-OR reduce cannot be).
    """
    if plane.size == 0:
        return jnp.zeros(256, jnp.int32)
    from fpv_tpu.entropy.plane_codec import _hist_flat

    return _hist_flat(plane.reshape(-1).astype(jnp.int32), 256)


def _support_mask(plane: jax.Array) -> jax.Array:
    """[256] 0/1 exact-support superset of a u8 plane batch.

    Interval bounds are exact (full-plane min/max — one fused reduction
    pass, unlike exact per-bin counting at 256 compares/element).  Two
    interval views are intersected: the plain value domain and the
    recentered ``(v+128) & 255`` domain where mod-256 residuals (which
    cluster around 0 *and* 255) become one contiguous run around 128.
    The intersection of two supersets of the support is still a superset,
    so symbols outside the mask provably never occur and can get rANS
    frequency 0 (see normalize_freqs_device).
    """
    if plane.size == 0:
        return jnp.ones(256, jnp.int32)
    v = plane.reshape(-1).astype(jnp.int32)
    sym = jnp.arange(256, dtype=jnp.int32)
    m_plain = (sym >= jnp.min(v)) & (sym <= jnp.max(v))
    r = (v + 128) & 255
    rsym = (sym + 128) & 255
    m_rec = (rsym >= jnp.min(r)) & (rsym <= jnp.max(r))
    return (m_plain & m_rec).astype(jnp.int32)


def _batch_hist(plane: jax.Array) -> jax.Array:
    """[256] int32 row-sampled histogram over the whole batch.

    Sampled (not exact) — tables built from it must use
    ``normalize_freqs(..., ensure_all=True)`` so unsampled symbols stay
    encodable.  Computed as a compare-and-reduce, which fuses into one
    reduction pass.
    """
    from fpv_tpu.entropy.plane_codec import _hist_flat

    return _hist_flat(
        _sample_rows(plane, _HIST_STRIDE).reshape(-1).astype(jnp.int32), 256
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "shift", "big_endian", "use_delta_frame", "low_ctx", "allow_prev",
    ),
)
def encode_model_step(
    imgs: jax.Array,
    delta_high: jax.Array,
    delta_low: jax.Array,
    shift: int = 0,
    big_endian: bool = False,
    use_delta_frame: bool = True,
    low_ctx: bool = False,
    allow_prev: bool = False,
):
    """The fused per-batch modeling program (everything but entropy coding).

    Returns residual planes, previews, per-frame decisions and batch
    histograms — all device arrays.

    ``allow_prev`` adds the prev-frame temporal candidate (F_USE_PREV):
    each frame may predict against the previous frame's planes instead of
    the static delta frame.  Every PREV_ANCHOR-th frame is barred from it
    so random access within a batch stays bounded (chains never exceed
    PREV_ANCHOR-1 frames; pure encoder policy — decoders accept any
    chain).  Frame 0's previous frame would be the delta section itself,
    which the anchor at t=0 makes moot.
    """
    high, low, nonzero_low = split_planes(imgs, shift, big_endian)
    pv = generate_preview(high)

    if use_delta_frame:
        dh = high - delta_high[None]
        dl = low - delta_low[None]
        cost_none = _residual_cost(high)
        cost_stat = _residual_cost(dh)
        if allow_prev:
            prevh = jnp.concatenate([delta_high[None], high[:-1]], axis=0)
            prevl = jnp.concatenate([delta_low[None], low[:-1]], axis=0)
            dph = high - prevh
            dpl = low - prevl
            b = imgs.shape[0]
            anchored = (jnp.arange(b) % PREV_ANCHOR) == 0
            cost_prev = jnp.where(
                anchored, jnp.float32(jnp.inf), _residual_cost(dph)
            )
            mode = jnp.argmin(
                jnp.stack([cost_none, cost_stat, cost_prev]), axis=0
            )
            use_delta = mode == 1
            use_prev = mode == 2
            ud = use_delta[:, None, None]
            up = use_prev[:, None, None]
            high2 = jnp.where(up, dph, jnp.where(ud, dh, high))
            low2 = jnp.where(up, dpl, jnp.where(ud, dl, low))
        else:
            use_delta = cost_stat < cost_none
            use_prev = jnp.zeros(imgs.shape[0], jnp.bool_)
            ud = use_delta[:, None, None]
            high2 = jnp.where(ud, dh, high)
            low2 = jnp.where(ud, dl, low)
    else:
        use_delta = jnp.zeros(imgs.shape[0], jnp.bool_)
        use_prev = jnp.zeros(imgs.shape[0], jnp.bool_)
        high2, low2 = high, low

    # spatial decision from sampled row PAIRS (true neighbor statistics at a
    # fraction of the cost) with a per-frame rotating phase (see
    # _sample_rows_rotating), then compute only the predictors some frame
    # actually chose (lax.cond skips the unused full-plane transforms)
    from fpv_tpu.ops.predict import clamped_gradient

    bsz, hh, _ww = high2.shape
    nrp = max((hh - 1) // _DECISION_STRIDE, 1)
    offs = jnp.arange(bsz, dtype=jnp.int32) % _DECISION_STRIDE
    offs = jnp.minimum(
        offs, max(hh - 2 - (nrp - 1) * _DECISION_STRIDE, 0)
    )
    pidx = offs[:, None] + _DECISION_STRIDE * jnp.arange(
        nrp, dtype=jnp.int32
    )[None, :]
    nr = jnp.take_along_axis(high2, pidx[:, :, None], axis=1)
    cur_rows = jnp.take_along_axis(
        high2, jnp.minimum(pidx + 1, hh - 1)[:, :, None], axis=1
    )
    up_s = cur_rows - nr
    w_s = jnp.roll(cur_rows, 1, axis=2)
    nw_s = jnp.roll(nr, 1, axis=2)
    cg_s = cur_rows - clamped_gradient(nr, w_s, nw_s)

    def _cost(x):
        xi = x.astype(jnp.int32).reshape(x.shape[0], -1)
        # float32 accumulation (comparison-only cost; int32 wraps on
        # maximum-dimension frames)
        return jnp.sum(jnp.minimum(xi, 256 - xi).astype(jnp.float32), axis=1)

    ent = jnp.stack([_cost(cur_rows), _cost(up_s), _cost(cg_s)])
    spatial = jnp.argmin(ent, axis=0).astype(jnp.int32)  # [B] in {0,1,2}
    s1 = (spatial == SPATIAL_UP)[:, None, None]
    s2 = (spatial == SPATIAL_CG2D)[:, None, None]
    c_up = jax.lax.cond(
        jnp.any(spatial == SPATIAL_UP), up_encode, lambda x: x, high2
    )
    c_cg = jax.lax.cond(
        jnp.any(spatial == SPATIAL_CG2D), cg2d_encode, lambda x: x, high2
    )
    high3 = jnp.where(s1, c_up, jnp.where(s2, c_cg, high2))

    # preview delta prediction (F_PV_USE_DELTA): the delta frame's preview
    # is computable on both sides, so temporally-correlated previews pay
    # only their change — and identical frames' preview residuals collapse
    # to zero (CODING_CONST then drops the stream entirely)
    if use_delta_frame:
        pv_delta = generate_preview(delta_high[None])[0]
        pvd = pv - pv_delta[None]
        pv_use_delta = _residual_cost(pvd) < _residual_cost(pv)
        pv2 = jnp.where(pv_use_delta[:, None, None], pvd, pv)
    else:
        pv_use_delta = jnp.zeros(imgs.shape[0], jnp.bool_)
        pv2 = pv

    p_up = up_encode(pv2)
    p_cg = cg2d_encode(pv2)
    pent = jnp.stack(
        [_residual_cost(pv2), _residual_cost(p_up), _residual_cost(p_cg)]
    )
    pv_spatial = jnp.argmin(pent, axis=0).astype(jnp.int32)
    pv3 = jnp.where(
        (pv_spatial == SPATIAL_UP)[:, None, None],
        p_up,
        jnp.where((pv_spatial == SPATIAL_CG2D)[:, None, None], p_cg, pv2),
    )

    return dict(
        high=high3,
        low=low2,
        preview=pv3,
        use_delta=use_delta,
        use_prev=use_prev,
        spatial=spatial,
        pv_spatial=pv_spatial,
        pv_use_delta=pv_use_delta,
        nonzero_low=nonzero_low,
        hist_high=_batch_hist(high3),
        # with the context-coded low mode the joint (ctx, sym) histogram is
        # computed from the block layout in fused_encode_batch instead
        hist_low=None if low_ctx else _batch_hist(low2),
        # the preview plane is small (1/16 of pixels): exact histogram +
        # exact support (non-contiguous: residuals of even-valued planes)
        hist_preview=(pv_hist := _exact_hist_256(pv3)),
        # exact-support masks let table floors skip provably-absent symbols
        mask_high=_support_mask(high3),
        mask_low=None if low_ctx else _support_mask(low2),
        mask_preview=(pv_hist > 0).astype(jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("any_up", "any_cg"))
def _inverse_spatial(res: jax.Array, spatial: jax.Array, any_up: bool, any_cg: bool):
    out = res
    if any_up:
        u = up_decode(res)
        out = jnp.where((spatial == SPATIAL_UP)[:, None, None], u, out)
    if any_cg:
        c = cg2d_decode(res)
        out = jnp.where((spatial == SPATIAL_CG2D)[:, None, None], c, out)
    return out


@jax.jit
def _apply_delta_and_combine(high, low, use_delta, delta_high, delta_low):
    ud = use_delta[:, None, None]
    h = jnp.where(ud, high + delta_high[None], high)
    l = jnp.where(ud, low + delta_low[None], low)
    return combine_planes(h, l)


@functools.partial(jax.jit, static_argnames=("any_prev",))
def _apply_temporal_and_combine(
    high, low, use_delta, use_prev, delta_high, delta_low,
    any_prev: bool = False,
):
    """Invert the temporal prediction and combine planes -> u16 images.

    Without F_USE_PREV frames this is the vectorized delta-add.  With them
    the inverse is a mod-256 cumulative scan along the frame axis: frame t
    adds the previous frame's reconstructed planes.  B scan steps of [H,W]
    u8 adds — trivial HBM traffic next to the rANS kernels, and the price
    of a temporal model the reference's per-frame decode loop could never
    amortize (fusion_power_video.cc:517-544 is static-delta only)."""
    if not any_prev:
        return _apply_delta_and_combine(
            high, low, use_delta, delta_high, delta_low
        )
    zero_h = jnp.zeros_like(delta_high)
    zero_l = jnp.zeros_like(delta_low)

    def step(carry, x):
        ph, pl2 = carry
        rh, rl, ud, up = x
        pred_h = jnp.where(up, ph, jnp.where(ud, delta_high, zero_h))
        pred_l = jnp.where(up, pl2, jnp.where(ud, delta_low, zero_l))
        hh = rh + pred_h  # uint8 wraparound
        ll = rl + pred_l
        return (hh, ll), (hh, ll)

    # frame 0's "previous frame" is the delta section (encoders anchor
    # frame 0 anyway, making the two temporal modes coincide there)
    _, (hs, ls) = jax.lax.scan(
        step, (delta_high, delta_low), (high, low, use_delta, use_prev)
    )
    return combine_planes(hs, ls)


# ---------------------------------------------------------------------------
# fused single-program batch paths (device engine): one jit = one device
# round trip per batch.  Table normalization, all three plane preps, rANS
# kernel launches and payload compaction happen inside the program, so the
# host syncs once per batch, not per phase.


def _plane_geometry(b: int, s: int, chunk_len: int):
    from fpv_tpu.ops.rans_layout import BLOCK_LANES, chunk_lens

    lens = chunk_lens(b, s, chunk_len)
    nblocks = len(lens) // BLOCK_LANES
    return lens, nblocks


@functools.partial(
    jax.jit,
    static_argnames=(
        "shift", "big_endian", "chunk_len", "use_delta_frame", "low_coding",
        "allow_prev",
    ),
)
def fused_encode_batch(
    imgs: jax.Array,
    delta_high: jax.Array,
    delta_low: jax.Array,
    shift: int,
    big_endian: bool,
    chunk_len: int,
    use_delta_frame: bool = True,
    low_coding: int = 0,
    allow_prev: bool = False,
):
    """Whole-batch FPVT encode as ONE device program.

    Returns (small u32 [L], states u32 [C], payload_high u16, payload_low
    u16, payload_pv u16).  ``small`` packs, in order: use_delta, use_prev,
    spatial, pv_spatial, nonzero_low (B each), then per plane (high, low,
    preview): freq[256] and block counts — only what the host needs to
    locate the stream.  ``states`` concatenates the per-chunk final states of the
    three planes; like the payloads it is part of the compressed stream
    and can stay in HBM until the file is written.  Payload buffers are
    worst-case-sized; their true lengths are the per-plane count sums.
    """
    from fpv_tpu.entropy.plane_codec import (
        _hist_flat,
        _to_block_symbols,
        ctx_combine_device,
    )
    from fpv_tpu.entropy.tables_device import (
        encode_tables_ctx_device,
        encode_tables_device,
        normalize_freqs_ctx_device,
        normalize_freqs_device,
    )
    from fpv_tpu import backend
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import (
        BLOCK_LANES,
        CODING_CTX16,
        CTX_NIDX,
        CTX_PROB_BITS,
        SEG_LEN,
    )

    interpret = backend.interpret()
    low_ctx = low_coding == CODING_CTX16
    m = encode_model_step(
        imgs, delta_high, delta_low, shift, big_endian, use_delta_frame,
        low_ctx, allow_prev,
    )
    b = imgs.shape[0]
    small = [
        m["use_delta"].astype(jnp.uint32),
        m["use_prev"].astype(jnp.uint32),
        m["spatial"].astype(jnp.uint32),
        m["pv_spatial"].astype(jnp.uint32),
        m["pv_use_delta"].astype(jnp.uint32),
        m["nonzero_low"].astype(jnp.uint32),
    ]
    payloads = []
    all_states = []
    for name in ("high", "low", "preview"):
        plane = m[name].reshape(b, -1)
        s = plane.shape[1]
        # constant-plane short-circuit signal: the host packager replaces
        # the whole stream with a CODING_CONST record when min == max
        # (repeated frames' residual planes are all-zero after delta)
        vmin = jnp.min(plane).astype(jnp.uint32) if s else jnp.uint32(0)
        vmax = jnp.max(plane).astype(jnp.uint32) if s else jnp.uint32(0)
        small.append(
            jnp.stack([(vmin == vmax).astype(jnp.uint32), vmin])
        )
        k_p = pv_chunk_len(chunk_len) if name == "preview" else chunk_len
        lens, nblocks = _plane_geometry(b, s, k_p)
        lens_dev = jnp.asarray(lens.reshape(nblocks, BLOCK_LANES))
        if name == "low" and low_ctx:
            # the kernel computes ctx*16+sym in-register from the previous
            # step's symbols, so no full-size index array materializes in
            # HBM; the table histogram samples the STEP axis (contiguous
            # slices, not a flat strided gather)
            sym4 = _to_block_symbols(plane >> 4, k_p, nblocks)
            nbk = sym4.shape[0]
            sampled = sym4[:, :: _HIST_STRIDE]
            prev_s = jnp.concatenate(
                [
                    jnp.zeros((nbk, 1, BLOCK_LANES), jnp.int32),
                    sym4[:, _HIST_STRIDE - 1 : -1 : _HIST_STRIDE].astype(
                        jnp.int32
                    ),
                ],
                axis=1,
            )[:, : sampled.shape[1]]
            idx_s = ctx_combine_device(prev_s, sampled)
            hist = _hist_flat(idx_s.reshape(-1), CTX_NIDX)
            # exact (ctx, sym) presence: floors only pairs that occur
            from fpv_tpu.entropy.plane_codec import ctx_presence_device

            mask = ctx_presence_device(sym4)
            freq = normalize_freqs_ctx_device(hist, mask)
            states, words, counts = rt.encode(
                sym4, lens_dev, encode_tables_ctx_device(freq), k_p,
                prob_bits=CTX_PROB_BITS, ctx_mode=True, interpret=interpret,
            )
        else:
            freq = normalize_freqs_device(m[f"hist_{name}"], m[f"mask_{name}"])
            syms = _to_block_symbols(plane, k_p, nblocks)
            states, words, counts = rt.encode(
                syms, lens_dev, encode_tables_device(freq), k_p,
                interpret=interpret,
            )
        counts_flat = counts.astype(jnp.uint32)
        cum = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts_flat).astype(jnp.int32)]
        )
        from fpv_tpu.entropy.plane_codec import _compact_payload

        # worst case one word per symbol: each group's full segment window
        win = min(k_p, SEG_LEN) * BLOCK_LANES
        payloads.append(
            _compact_payload(words, cum, words.shape[0] * win, win)
        )
        small.append(freq)
        small.append(counts_flat)
        all_states.append(states.reshape(-1))
    return (jnp.concatenate(small), jnp.concatenate(all_states), *payloads)


def _fused_decodable(pb: "fpvt.ParsedBatch", chunk_len: int) -> bool:
    """True when every plane stream of a parsed batch can decode inside the
    fused device program: present, and either CODING_CONST or coded with
    the device-kernel geometry (1024 lanes; main planes at the header
    chunk length, the preview at any kernel-valid chunk — the stream
    carries its own, see PV_CHUNK_MAX).  Narrow (host-coded) streams fall
    back to the per-plane path."""
    from fpv_tpu.ops.rans_layout import BLOCK_LANES as _BL
    from fpv_tpu.ops.rans_layout import CODING_CONST as _CC
    from fpv_tpu.ops.rans_layout import CODING_RAW as _CR
    from fpv_tpu.ops.rans_layout import SEG_LEN as _SL

    for st, is_pv in ((pb.high, False), (pb.low, False), (pb.preview, True)):
        if st is None:
            return False
        if st.coding in (_CC, _CR):
            continue
        if st.lanes != _BL:
            return False
        if is_pv:
            # any segment-compatible chunk decodes in the fused program
            if st.chunk_len > _SL and st.chunk_len % _SL:
                return False
        elif st.chunk_len != chunk_len:
            return False
    return True


def batch_decode_args(pb: "fpvt.ParsedBatch", chunk_len: int):
    """Assemble :func:`fused_decode_batch`'s inputs from a parsed batch.

    Host-side packaging shared by the reader's fused path, the benchmark
    harness, and the sharded decode layer.  Returns ``(arrays, static)``:
    ``arrays`` is a dict of numpy arrays (payload, plane_offs, counts,
    states, flags, tables, const_vals); ``static`` is a dict of the
    shape-static kwargs (pv_chunk_len, low_ctx, const_planes, raw_planes,
    any_up, any_cg, pv_any_up, pv_any_cg, any_pv_delta, any_prev).  The
    payload length is bucketed (``_quantize_cap``) so sections share
    compiled programs; the sharded decode layer zero-pads a stack of
    sections to one length.
    """
    from fpv_tpu.entropy.plane_codec import _quantize_cap
    from fpv_tpu.format.fpvt import F_PV_USE_DELTA, F_USE_PREV
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import CODING_CONST, CODING_RAW, PROB_SCALE

    streams = [pb.high, pb.low, pb.preview]
    if len(pb.frame_flags) * pb.high.plane_size > MAX_DEVICE_SYMS:
        raise ValueError(
            "batch too large for the device codec (2^31 symbols)"
        )
    # CODING_CONST planes carry no coded data: they are excluded from every
    # concatenated array and flagged to the program instead.  CODING_RAW
    # planes ride the shared payload buffer (their stored bytes, u16-packed)
    # but contribute no counts/states/tables.
    const_planes = tuple(st.coding == CODING_CONST for st in streams)
    raw_planes = tuple(st.coding == CODING_RAW for st in streams)
    const_vals = np.array(
        [st.value if c else 0 for st, c in zip(streams, const_planes)],
        np.uint32,
    )
    coded = [
        st
        for st, c, r in zip(streams, const_planes, raw_planes)
        if not (c or r)
    ]
    plane_offs = np.zeros(3, np.int32)
    parts = []
    pos = 0
    for i, st in enumerate(streams):
        plane_offs[i] = pos
        if not const_planes[i]:
            parts.append(st.payload)
            pos += st.payload.size
    cap = _quantize_cap(
        pos, chunk_len, max(sum(s.num_blocks for s in coded), 1)
    )
    payload = np.zeros(cap, np.uint16)
    payload[:pos] = np.concatenate(parts) if parts else payload[:0]
    counts = np.concatenate(
        [s.block_counts for s in coded] or [np.zeros(0, np.uint32)]
    ).astype(np.uint32)
    states = np.concatenate(
        [s.states for s in coded] or [np.zeros(0, np.uint32)]
    ).astype(np.uint32)
    # fused decode tables, one u32 entry per slot (ctx: per (ctx, slot))
    tables = np.zeros((3, PROB_SCALE), np.uint32)
    for i, st in enumerate(streams):
        if const_planes[i] or raw_planes[i]:
            continue
        if st.coding:
            tables[i] = rt.ctx_fused_table(st.freq)
        else:
            tables[i] = rt.fused_table(st.freq)
    spatial = (pb.frame_flags >> F_SPATIAL_SHIFT) & 3
    pv_spatial = (pb.frame_flags >> F_PV_SPATIAL_SHIFT) & 3
    arrays = dict(
        payload=payload,
        plane_offs=plane_offs,
        counts=counts,
        states=states,
        flags=pb.frame_flags.astype(np.uint32),
        tables=tables,
        const_vals=const_vals,
    )
    static = dict(
        pv_chunk_len=int(pb.preview.chunk_len),
        low_ctx=bool(pb.low.coding == 1),
        const_planes=const_planes,
        raw_planes=raw_planes,
        any_up=bool((spatial == SPATIAL_UP).any()),
        any_cg=bool((spatial == SPATIAL_CG2D).any()),
        pv_any_up=bool((pv_spatial == SPATIAL_UP).any()),
        pv_any_cg=bool((pv_spatial == SPATIAL_CG2D).any()),
        any_pv_delta=bool((pb.frame_flags & F_PV_USE_DELTA).any()),
        any_prev=bool((pb.frame_flags & F_USE_PREV).any()),
    )
    return arrays, static


def _small_layout(b: int, h: int, w: int, chunk_len: int, low_coding: int = 0):
    """Offsets into fused_encode_batch's ``small`` vector, plus offsets of
    each plane's chunk states inside the separate ``states`` vector."""
    from fpv_tpu.ops.rans_layout import BLOCK_LANES as _BL
    from fpv_tpu.ops.rans_layout import CODING_CTX16, CTX_NIDX, num_segments

    sizes = [b, b, b, b, b, b]
    names = ["use_delta", "use_prev", "spatial", "pv_spatial",
             "pv_use_delta", "nonzero_low"]
    st_sizes, st_names = [], []
    for name, s in (("high", h * w), ("low", h * w), ("preview", (h // 4) * (w // 4))):
        k_p = pv_chunk_len(chunk_len) if name == "preview" else chunk_len
        nseg = num_segments(k_p)
        _lens, nblocks = _plane_geometry(b, s, k_p)
        nfreq = (
            CTX_NIDX
            if (name == "low" and low_coding == CODING_CTX16)
            else 256
        )
        sizes += [2, nfreq, nblocks * nseg]
        names += [f"const_{name}", f"freq_{name}", f"counts_{name}"]
        st_sizes.append(nblocks * _BL)
        st_names.append(f"states_{name}")
    offs = np.cumsum([0] + sizes)
    lay = {n: (int(offs[i]), int(offs[i + 1])) for i, n in enumerate(names)}
    st_offs = np.cumsum([0] + st_sizes)
    for i, n in enumerate(st_names):
        lay[n] = (int(st_offs[i]), int(st_offs[i + 1]))
    return lay


@functools.partial(
    jax.jit,
    static_argnames=("chunk_len", "b", "h", "w", "any_up", "any_cg",
                     "pv_any_up", "pv_any_cg", "decode_preview",
                     "low_ctx", "const_planes", "any_pv_delta", "pack_u8",
                     "any_prev", "raw_planes", "pv_chunk_len"),
)
def fused_decode_batch(
    payload: jax.Array,  # u16, all planes concatenated
    plane_offs: jax.Array,  # i32 [3] start of each plane's payload
    counts: jax.Array,  # u32 concatenated per plane
    states: jax.Array,  # u32 concatenated per plane
    flags: jax.Array,  # u32 [B] frame flags
    tables: jax.Array,  # u32 [3, PROB_SCALE] fused decode tables
    delta_high: jax.Array,
    delta_low: jax.Array,
    const_vals: jax.Array,  # u32 [3] value of each CODING_CONST plane
    chunk_len: int,
    b: int,
    h: int,
    w: int,
    any_up: bool,
    any_cg: bool,
    pv_any_up: bool,
    pv_any_cg: bool,
    decode_preview: bool = False,
    low_ctx: bool = False,
    const_planes: tuple = (False, False, False),
    any_pv_delta: bool = False,
    pack_u8: bool = False,
    any_prev: bool = False,
    raw_planes: tuple = (False, False, False),
    pv_chunk_len: int | None = None,
):
    """Whole-batch FPVT decode as ONE device program -> (imgs u16, ok).

    ``pv_chunk_len``: the preview stream's own chunk length (the wire
    carries it per stream; new writers use PV_CHUNK_MAX).  None means the
    header chunk (pre-change files).

    ``const_planes[pi]`` marks a CODING_CONST stream: the residual plane is
    ``const_vals[pi]`` everywhere and contributes nothing to counts/states/
    payload (which are concatenations over the NON-const planes only).
    ``raw_planes[pi]`` marks a CODING_RAW stream: the residual plane's bytes
    sit verbatim (u16-packed) in the payload buffer at ``plane_offs[pi]`` —
    an unpack instead of a rANS kernel launch."""
    from fpv_tpu import backend
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import BLOCK_LANES, CTX_PROB_BITS
    from fpv_tpu.entropy.plane_codec import _from_block_symbols

    from fpv_tpu.ops.rans_layout import num_segments

    interpret = backend.interpret()
    pv_k = pv_chunk_len or chunk_len
    geoms = []
    for s, k_p in (
        (h * w, chunk_len), (h * w, chunk_len),
        ((h // 4) * (w // 4), pv_k),
    ):
        geoms.append((s, k_p, *_plane_geometry(b, s, k_p)))

    planes = []
    oks = []
    coff = 0
    soff = 0
    for pi, (s, k_p, lens, nblocks) in enumerate(geoms):
        ngroups = nblocks * num_segments(k_p)
        if pi == 2 and not decode_preview:
            planes.append(None)
            continue
        if const_planes[pi]:
            planes.append(
                jnp.full((b, s), 0, jnp.uint8) + const_vals[pi].astype(jnp.uint8)
            )
            continue
        if raw_planes[pi]:
            # stored plane: unpack the u16-packed bytes from the shared
            # payload buffer (little-endian pairs) — no kernel, no checks
            n = b * s
            n2 = -(-n // 2)
            wsl = jax.lax.dynamic_slice(payload, (plane_offs[pi],), (n2,))
            byts = jnp.stack([wsl & 0xFF, wsl >> 8], axis=-1).reshape(-1)
            planes.append(byts[:n].astype(jnp.uint8).reshape(b, s))
            continue
        c = nblocks * BLOCK_LANES
        cnt = counts[coff : coff + ngroups].astype(jnp.int32)
        st_pad = states[soff : soff + c]
        coff += ngroups
        soff += c
        starts = plane_offs[pi] + jnp.cumsum(cnt) - cnt
        ctx = low_ctx and pi == 1
        syms, ok = rt.decode(
            cnt, starts, payload,
            st_pad.reshape(nblocks, BLOCK_LANES),
            jnp.asarray(lens.reshape(nblocks, BLOCK_LANES)),
            tables[pi], k_p,
            prob_bits=CTX_PROB_BITS if ctx else 12, ctx_mode=ctx,
            interpret=interpret,
        )
        out_plane = _from_block_symbols(syms, b, s, k_p)
        if ctx:
            out_plane = (out_plane << 4).astype(jnp.uint8)
        planes.append(out_plane)
        oks.append(jnp.all(ok == 1))

    high = planes[0].reshape(b, h, w)
    low = planes[1].reshape(b, h, w)
    spatial = ((flags >> F_SPATIAL_SHIFT) & 3).astype(jnp.int32)
    high = _inverse_spatial(high, spatial, any_up, any_cg)
    use_delta = (flags & F_USE_DELTA) != 0
    use_prev = (flags & fpvt.F_USE_PREV) != 0
    imgs = _apply_temporal_and_combine(
        high, low, use_delta, use_prev, delta_high, delta_low, any_prev
    )
    if pack_u8:
        # emit the frames as their little-endian byte stream [b*h, 2w] u8
        # (the host views the bytes back to u16 for free); the [b,h,w,2]
        # bitcast intermediate fuses into the output copy
        imgs = jax.lax.bitcast_convert_type(imgs, jnp.uint8).reshape(
            b * h, 2 * w
        )
    ok_all = jnp.all(jnp.stack(oks)) if oks else jnp.bool_(True)
    if decode_preview:
        pv = planes[2].reshape(b, h // 4, w // 4)
        pv = _inverse_preview(pv, flags, delta_high, pv_any_up, pv_any_cg,
                              any_pv_delta)
        return imgs, ok_all, pv
    return imgs, ok_all


@functools.partial(
    jax.jit,
    static_argnames=("chunk_len", "h", "w", "spatial", "use_delta",
                     "no_low", "low_ctx"),
)
def fused_decode_frame(
    pay_h: jax.Array,  # u16 payload slice of the covering blocks
    cnt_h: jax.Array,  # i32 [nbh * nseg]
    st_h: jax.Array,  # u32 [nbh, 1024]
    lens_h: jax.Array,  # i32 [nbh, 1024]
    off_h: jax.Array,  # i32 scalar: frame start within the sub-blocks' syms
    pay_l: jax.Array,
    cnt_l: jax.Array,
    st_l: jax.Array,
    lens_l: jax.Array,
    off_l: jax.Array,
    tab_h: jax.Array,  # u32 [PROB_SCALE] fused decode table
    tab_l: jax.Array,
    delta_high: jax.Array,
    delta_low: jax.Array,
    chunk_len: int,
    h: int,
    w: int,
    spatial: int,
    use_delta: bool,
    no_low: bool,
    low_ctx: bool,
):
    """Decode ONE frame from only its covering rANS blocks -> ([h,w] u16, ok).

    The sub-batch random-access fast path: the FPVT block layout keeps
    blocks contiguous in the flat pixel stream precisely so a single frame
    needs only ceil(S/span)+1 blocks per plane (the role of
    RandomAccessDecoder::DecodeFrame, fusion_power_video.cc:1017-1036)."""
    from fpv_tpu import backend
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import CTX_PROB_BITS

    s = h * w

    def dec(pay, cnt, st, lens, off, tab, ctx):
        syms, ok = rt.decode(
            cnt, jnp.cumsum(cnt) - cnt, pay, st, lens, tab, chunk_len,
            prob_bits=CTX_PROB_BITS if ctx else 12, ctx_mode=ctx,
            interpret=backend.interpret(),
        )
        flat = syms.reshape(-1)
        plane = jax.lax.dynamic_slice(flat, (off,), (s,)).astype(jnp.uint8)
        return plane, jnp.all(ok == 1)

    high, ok_h = dec(pay_h, cnt_h, st_h, lens_h, off_h, tab_h, False)
    high = high.reshape(1, h, w)
    if spatial == SPATIAL_UP:
        high = up_decode(high)
    elif spatial == SPATIAL_CG2D:
        high = cg2d_decode(high)
    if no_low:
        low = jnp.zeros((1, h, w), jnp.uint8)
        ok_l = jnp.bool_(True)
    else:
        low, ok_l = dec(pay_l, cnt_l, st_l, lens_l, off_l, tab_l, low_ctx)
        if low_ctx:
            low = (low << 4).astype(jnp.uint8)
        low = low.reshape(1, h, w)
    if use_delta:
        high = high + delta_high[None]
        low = (low + delta_low[None]) if not no_low else low
    img = combine_planes(high, low)[0]
    return img, ok_h & ok_l


@functools.partial(
    jax.jit,
    static_argnames=("chunk_len", "b", "ph", "pw", "pv_any_up", "pv_any_cg",
                     "any_pv_delta"),
)
def fused_decode_preview(
    payload: jax.Array,  # u16
    counts: jax.Array,  # i32 [nblocks * nseg]
    states: jax.Array,  # u32 [nblocks*1024]
    flags: jax.Array,  # u32 [B]
    table: jax.Array,  # u32 [PROB_SCALE] fused decode table
    delta_high: jax.Array,
    chunk_len: int,
    b: int,
    ph: int,
    pw: int,
    pv_any_up: bool,
    pv_any_cg: bool,
    any_pv_delta: bool = False,
):
    """Preview-only decode as ONE device program -> ([B,ph,pw] u8, ok).

    The fast-path analog of RandomAccessDecoder::DecodePreview
    (fusion_power_video.cc:1038-1070): previews decode without touching the
    main planes."""
    from fpv_tpu import backend
    from fpv_tpu.entropy.plane_codec import _from_block_symbols
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import BLOCK_LANES

    s = ph * pw
    lens, nblocks = _plane_geometry(b, s, chunk_len)
    syms, ok = rt.decode(
        counts, jnp.cumsum(counts) - counts, payload,
        states.reshape(nblocks, BLOCK_LANES),
        jnp.asarray(lens.reshape(nblocks, BLOCK_LANES)), table, chunk_len,
        interpret=backend.interpret(),
    )
    pv = _from_block_symbols(syms, b, s, chunk_len).reshape(b, ph, pw)
    pv = _inverse_preview(pv, flags, delta_high, pv_any_up, pv_any_cg,
                          any_pv_delta)
    return pv, jnp.all(ok == 1)


@functools.partial(
    jax.jit, static_argnames=("pv_any_up", "pv_any_cg", "any_pv_delta")
)
def _inverse_preview(
    pv: jax.Array,
    flags: jax.Array,
    delta_high: jax.Array,
    pv_any_up: bool,
    pv_any_cg: bool,
    any_pv_delta: bool,
):
    """Invert a preview residual batch: spatial prediction, then the delta
    against the delta frame's preview (F_PV_USE_DELTA)."""
    pv_spatial = ((flags >> F_PV_SPATIAL_SHIFT) & 3).astype(jnp.int32)
    pv = _inverse_spatial(pv, pv_spatial, pv_any_up, pv_any_cg)
    if any_pv_delta:
        from fpv_tpu.format.fpvt import F_PV_USE_DELTA

        pv_delta = generate_preview(delta_high[None])[0]
        pvd = ((flags & F_PV_USE_DELTA) != 0)[:, None, None]
        pv = jnp.where(pvd, pv + pv_delta[None], pv)
    return pv


@functools.partial(jax.jit, static_argnames=("shift", "big_endian"))
def _residual_planes_for_flags(
    imgs: jax.Array,
    delta_high: jax.Array,
    delta_low: jax.Array,
    use_delta: jax.Array,  # [B] bool
    use_prev: jax.Array,  # [B] bool
    spatial: jax.Array,  # [B] i32
    pv_spatial: jax.Array,  # [B] i32
    pv_use_delta: jax.Array,  # [B] bool
    shift: int,
    big_endian: bool,
):
    """Recompute the residual planes :func:`encode_model_step` produced,
    given its (already-made) per-frame decisions -> (high, low, preview).

    Integer-exact twin of the model step's transform half: the flags pin
    every select, and all ops are u8 modular arithmetic, so the output
    matches the fused encoder's residuals bit for bit.  Used by the host
    packager when a plane's rANS stream loses to a CODING_RAW store — the
    fused program's outputs are the coded streams only, so the raw bytes
    are re-derived on device (cost paid only for incompressible planes,
    where it replaces an equal-size payload pull)."""
    high, low, _nz = split_planes(imgs, shift, big_endian)
    pv = generate_preview(high)
    prevh = jnp.concatenate([delta_high[None], high[:-1]], axis=0)
    prevl = jnp.concatenate([delta_low[None], low[:-1]], axis=0)
    ud = use_delta[:, None, None]
    up = use_prev[:, None, None]
    high2 = jnp.where(
        up, high - prevh, jnp.where(ud, high - delta_high[None], high)
    )
    low2 = jnp.where(
        up, low - prevl, jnp.where(ud, low - delta_low[None], low)
    )
    s1 = (spatial == SPATIAL_UP)[:, None, None]
    s2 = (spatial == SPATIAL_CG2D)[:, None, None]
    high3 = jnp.where(
        s1, up_encode(high2), jnp.where(s2, cg2d_encode(high2), high2)
    )
    pv_delta = generate_preview(delta_high[None])[0]
    pv2 = jnp.where(pv_use_delta[:, None, None], pv - pv_delta[None], pv)
    p1 = (pv_spatial == SPATIAL_UP)[:, None, None]
    p2 = (pv_spatial == SPATIAL_CG2D)[:, None, None]
    pv3 = jnp.where(p1, up_encode(pv2), jnp.where(p2, cg2d_encode(pv2), pv2))
    return high3, low2, pv3


def package_encoded_batch(
    small: np.ndarray,
    states_all: np.ndarray,
    pay_h,
    pay_l,
    pay_p,
    *,
    b: int,
    h: int,
    w: int,
    chunk_len: int,
    low_coding: int,
    raw_ctx: dict | None = None,
):
    """Host-side packaging of one :func:`fused_encode_batch` output into
    section streams: ``(flags, (high, low, preview) PlaneStreams)``.

    ``small``/``states_all`` are numpy (already pulled); the payload arrays
    may stay on device — only each stream's exact prefix is materialized
    (the bucketed pull).  Shared by FpvtWriter's fused path and the sharded
    file encoder (parallel/mesh.py), whose per-device output slices carry
    exactly the single-device layout.

    ``raw_ctx`` (dict with imgs, delta_high, delta_low, shift, big_endian —
    the fused program's own inputs) enables the CODING_RAW policy: a plane
    whose rANS stream is not smaller than a verbatim store is re-derived
    via :func:`_residual_planes_for_flags` and stored raw.  The decision
    uses exact serialized sizes computed from the counts ALONE, so the
    losing payload is never pulled; without a context the coded stream is
    kept (size-identical files require all packagers of one file to agree)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from fpv_tpu.entropy.plane_codec import (
        PlaneStream,
        _quantize_cap,
        coded_stream_bytes,
        raw_plane_stream,
        raw_policy_enabled,
        raw_stream_bytes,
    )

    if raw_ctx is not None and not raw_policy_enabled():
        raw_ctx = None

    lay = _small_layout(b, h, w, chunk_len, low_coding)

    def seg(name):
        lo, hi = lay[name]
        return small[lo:hi]

    flags = FpvtWriter._pack_flags(
        seg("use_delta"), seg("spatial"), seg("pv_spatial"),
        seg("nonzero_low"), seg("pv_use_delta"), seg("use_prev"),
    )

    rec_lock = threading.Lock()
    rec_cache: dict = {}

    def recover(name: str) -> np.ndarray:
        """Residual bytes of one plane (lazy, one device program for all
        three; thread-safe — package() runs on a pool)."""
        with rec_lock:
            if not rec_cache:
                hi3, lo2, pv3 = _residual_planes_for_flags(
                    jnp.asarray(raw_ctx["imgs"]),
                    raw_ctx["delta_high"],
                    raw_ctx["delta_low"],
                    jnp.asarray(seg("use_delta").astype(bool)),
                    jnp.asarray(seg("use_prev").astype(bool)),
                    jnp.asarray(seg("spatial").astype(np.int32)),
                    jnp.asarray(seg("pv_spatial").astype(np.int32)),
                    jnp.asarray(seg("pv_use_delta").astype(bool)),
                    shift=raw_ctx["shift"],
                    big_endian=raw_ctx["big_endian"],
                )
                rec_cache.update(high=hi3, low=lo2, preview=pv3)
            return np.asarray(rec_cache[name]).reshape(b, -1)

    def package(name, pay_dev, s):
        k_p = pv_chunk_len(chunk_len) if name == "preview" else chunk_len
        is_const, cval = seg(f"const_{name}")
        if is_const:
            from fpv_tpu.entropy.plane_codec import const_plane_stream

            return const_plane_stream(b, s, k_p, int(cval))
        freq = seg(f"freq_{name}").astype(np.uint16)
        counts = seg(f"counts_{name}").astype(np.uint32)
        lo, hi = lay[f"states_{name}"]
        states = states_all[lo:hi].astype(np.uint32)
        from fpv_tpu.ops.rans_layout import BLOCK_LANES, num_segments

        total = int(counts.sum())
        nblocks = len(counts) // num_segments(k_p)
        if raw_ctx is not None and s and raw_stream_bytes(
            b * s
        ) <= coded_stream_bytes(nblocks * BLOCK_LANES, len(counts), total):
            return raw_plane_stream(b, s, k_p, recover(name))
        cap = _quantize_cap(total, k_p, nblocks)
        payload = np.asarray(pay_dev[: min(cap, pay_dev.shape[0])])[:total]
        coding = low_coding if name == "low" else 0
        return PlaneStream(
            nframes=b, plane_size=s, chunk_len=k_p, freq=freq,
            states=states, block_counts=counts, payload=payload,
            coding=coding,
        )

    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = [
            pool.submit(package, "high", pay_h, h * w),
            pool.submit(package, "low", pay_l, h * w),
            pool.submit(package, "preview", pay_p, (h // 4) * (w // 4)),
        ]
        hs, ls, pvs = (f.result() for f in futs)
    return flags, (hs, ls, pvs)


class FpvtWriter:
    """Streaming FPVT file writer: init -> encode_batch* -> finish."""

    def __init__(
        self,
        xsize: int,
        ysize: int,
        shift: int = 0,
        big_endian: bool = False,
        frames_per_batch: int = 16,
        chunk_log2: int = 12,
        device=None,
        delta_is_frame0: bool = False,
        narrow: bool = True,
        temporal_prev: bool = True,
    ) -> None:
        """``narrow``: apply the small-batch encoder policy (narrow lane
        counts + host coding for batches <= narrow_max_syms()).  The ~KB
        of saved per-batch state storage only matters when the whole FILE
        is small; host coding costs ~100x device throughput per batch, so
        long-lived writers (serving hubs, long videos of mid-size frames)
        should pass False — encode_file_fpvt / sharded_encode_file decide
        automatically from the total frame count (file_encode_setup).

        ``temporal_prev``: allow per-frame prev-frame prediction
        (F_USE_PREV, anchored every PREV_ANCHOR frames).  Strictly a
        per-frame cost-compared option, so disabling it only forgoes the
        temporal win; off is useful for A/B and for byte-stability against
        v4-era captures."""
        self._device = device  # optional jax.Device pinning this stream
        self._narrow = narrow
        self._allow_prev = temporal_prev
        self.header = Header(
            xsize=xsize,
            ysize=ysize,
            shift=shift,
            big_endian=big_endian,
            chunk_log2=chunk_log2,
            frames_per_batch=frames_per_batch,
            delta_is_frame0=delta_is_frame0,
        )
        self._chunk_len = 1 << chunk_log2
        # shift >= 4 guarantees the low plane's bottom nibble is zero
        # (values are (v << shift) & 0xFF), enabling the context-coded
        # 16-symbol mode (rans_layout CTX docs) — worth ~5% total ratio
        from fpv_tpu.ops.rans_layout import CODING_CTX16, CODING_ORDER0

        self._low_coding = CODING_CTX16 if shift >= 4 else CODING_ORDER0
        self._delta_high: jax.Array | None = None
        self._delta_low: jax.Array | None = None
        self._batch_offsets: list[tuple[int, int]] = []
        self._bytes_written = 0
        self._total_frames = 0

    def _put(self, arr: np.ndarray) -> jax.Array:
        if self._device is not None:
            return jax.device_put(arr, self._device)
        return jnp.asarray(arr)

    def init(self, delta_frame: np.ndarray) -> bytes:
        """Header + delta section bytes; keeps the delta planes on device.

        uint8 delta frames are accepted (8-bit direct input): widening is
        value-preserving and the shift==8 LE split recovers the same
        single-plane layout as Frame's uint8 ctor."""
        if np.asarray(delta_frame).dtype == np.uint8:
            from fpv_tpu.ops.planes import validate_u8_config

            validate_u8_config(self.header.shift, self.header.big_endian)
        img = self._put(
            np.asarray(delta_frame, dtype=np.uint16).reshape(
                1, self.header.ysize, self.header.xsize
            )
        )
        return self._init_core(
            img, self.header.shift, self.header.big_endian
        )

    def init_planes(
        self, high: np.ndarray, low: np.ndarray | None = None
    ) -> bytes:
        """Plane-adopting twin of :meth:`init` (the reference's plane ctor,
        fusion_power_video.cc:467-489): the delta frame enters as pre-split
        [H, W] uint8 byte planes; bytes identical to :meth:`init` on the
        combined image."""
        h, w = self.header.ysize, self.header.xsize
        high = np.ascontiguousarray(high, dtype=np.uint8)
        if high.shape != (h, w):
            raise ValueError("high plane must be [ysize, xsize] uint8")
        hi = self._put(high.reshape(1, h, w))
        imgs = hi.astype(jnp.uint16) << 8
        if low is not None:
            low = np.ascontiguousarray(low, dtype=np.uint8)
            if low.shape != (h, w):
                raise ValueError("low plane shape must match high plane")
            imgs = imgs | self._put(low.reshape(1, h, w)).astype(jnp.uint16)
        return self._init_core(imgs, 0, False)

    def _init_core(
        self, img: jax.Array, split_shift: int, split_big_endian: bool
    ) -> bytes:
        high, low, nonzero_low = split_planes(
            img, split_shift, split_big_endian
        )
        self._delta_high = high[0]
        self._delta_low = low[0]
        has_low = bool(np.asarray(nonzero_low)[0])
        # spatially predict the delta-section high plane (smooth delta
        # frames would otherwise pay full order-0 entropy; the reference's
        # delta chunk likewise goes through CG prediction + brotli,
        # fusion_power_video.cc:1097-1100).  Decision by EXACT Shannon
        # entropy, not |residual| (a constant-nonzero residual has large
        # magnitude but zero entropy — e.g. row-periodic ramps under 'up');
        # one frame on host, cheap.
        cands = [high, up_encode(high), cg2d_encode(high)]

        def _entropy_bits(c) -> float:
            cnt = np.bincount(np.asarray(c).reshape(-1), minlength=256)
            p = cnt[cnt > 0] / max(cnt.sum(), 1)
            return float(-(p * np.log2(p)).sum()) * c.size

        costs = [_entropy_bits(c) for c in cands]
        spatial = int(np.argmin(costs))
        hres = cands[spatial]
        from fpv_tpu.entropy.plane_codec import narrow_max_syms

        # small delta planes take the narrow host path (policy lanes="auto"),
        # which computes its own exact histogram (hist=None).  The threshold
        # is tighter than batch planes (512K vs 4M symbols): the ~4 KB/block
        # state saving only matters when the FILE is small, and init() sits
        # on the per-stream e2e critical path — host narrow coding of a
        # 1 Mpx delta plane costs seconds per stream open.
        small = self._narrow and (
            self.header.ysize * self.header.xsize
            <= min(512 * 1024, narrow_max_syms())
        )
        hs = encode_plane_batch(
            hres.reshape(1, -1),
            None if small else np.asarray(_batch_hist(hres)),
            self._chunk_len,
            mask=None if small else np.asarray(_support_mask(hres)),
            lanes="auto" if small else None,
            allow_raw=True,
        )
        ls = (
            encode_plane_batch(
                low.reshape(1, -1),
                (
                    None
                    if (self._low_coding or small)
                    else np.asarray(_batch_hist(low))
                ),
                self._chunk_len,
                coding=self._low_coding,
                mask=(
                    None
                    if (self._low_coding or small)
                    else np.asarray(_support_mask(low))
                ),
                lanes="auto" if small else None,
                allow_raw=True,
            )
            if has_low
            else None
        )
        dflags = (0 if has_low else F_NO_LOW) | (spatial << F_SPATIAL_SHIFT)
        out = self.header.serialize() + fpvt.serialize_delta_section(dflags, hs, ls)
        self._bytes_written = len(out)
        return out

    def encode_batch_bytes(
        self, imgs: np.ndarray, timestamps: np.ndarray | None = None
    ) -> bytes:
        """Pure section encoding (no writer bookkeeping) — thread-safe, so
        callers can pipeline several batches and assemble in order with
        :meth:`add_batch`."""
        if self._delta_high is None:
            raise RuntimeError("init() must be called first")
        imgs = np.asarray(imgs)
        if imgs.dtype == np.uint8:
            # 8-bit direct input rides the shift==8 single-plane layout
            # (Frame's uint8 ctor, fusion_power_video.cc:453-465); the
            # device split consumes uint8 natively, halving the upload
            from fpv_tpu.ops.planes import validate_u8_config

            validate_u8_config(self.header.shift, self.header.big_endian)
        else:
            imgs = np.asarray(imgs, dtype=np.uint16)
        imgs = self._put(imgs)
        return self._encode_batch_core(
            imgs, self.header.shift, self.header.big_endian, timestamps
        )

    def encode_batch_planes_bytes(
        self,
        high: np.ndarray,
        low: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
    ) -> bytes:
        """Pre-split byte-plane ingest (the reference's plane-adopting
        Frame ctor, fusion_power_video.cc:467-489): ``high`` (and optional
        ``low``) are [B, H, W] uint8 planes as the writer's shift config
        would have split them.  No host combine/split round trip — the
        planes upload as-is and the device-side combine fuses into the
        split's elementwise chain under XLA, so the encoded bytes are
        identical to :meth:`encode_batch_bytes` on the combined images."""
        if self._delta_high is None:
            raise RuntimeError("init() must be called first")
        high = np.ascontiguousarray(high, dtype=np.uint8)
        if high.ndim != 3:
            raise ValueError("high must be [B, H, W] uint8")
        hi = self._put(high)
        if low is None:
            imgs = hi.astype(jnp.uint16) << 8
        else:
            low = np.ascontiguousarray(low, dtype=np.uint8)
            if low.shape != high.shape:
                raise ValueError("low plane shape must match high plane")
            imgs = (hi.astype(jnp.uint16) << 8) | self._put(low).astype(
                jnp.uint16
            )
        # the combined image is left-aligned by construction, so the core
        # runs with a shift-0 little-endian split — which recovers exactly
        # the planes given (split(high<<8|low, 0, LE) == (high, low))
        return self._encode_batch_core(imgs, 0, False, timestamps)

    def encode_batch_planes(
        self,
        high: np.ndarray,
        low: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
    ) -> bytes:
        """Plane-ingest twin of :meth:`encode_batch` (records the batch)."""
        n = np.asarray(high).shape[0]
        return self.add_batch(
            self.encode_batch_planes_bytes(high, low, timestamps), n
        )

    def _encode_batch_core(
        self,
        imgs: jax.Array,
        split_shift: int,
        split_big_endian: bool,
        timestamps: np.ndarray | None,
    ) -> bytes:
        from fpv_tpu import backend
        from fpv_tpu.entropy.plane_codec import narrow_max_syms

        b = imgs.shape[0]
        # previews of H<4 or W<4 frames have zero pixels: skip the stream
        has_pv = (self.header.ysize // 4) * (self.header.xsize // 4) > 0
        n_main = b * self.header.ysize * self.header.xsize
        if n_main > MAX_DEVICE_SYMS:
            raise ValueError(
                "batch too large for the device codec (2^31 symbols); "
                "use smaller frames_per_batch"
            )
        # with the narrow policy on, small batches bypass the fused device
        # path so the encoder policy (const short-circuit, narrow lane
        # counts) can shrink their fixed per-stream costs; production-size
        # batches — and ALL batches of narrow=False writers (long files /
        # serving hubs, where host coding would be a ~100x throughput
        # cliff per batch) — keep the one-jit path (whose packager applies
        # the const short-circuit itself)
        if backend.engine() != "numpy" and (
            not self._narrow or n_main > narrow_max_syms()
        ):
            flags, streams = self._encode_batch_fused(
                imgs, b, split_shift, split_big_endian
            )
            hs, ls, pvs = streams
            if not has_pv:
                pvs = None
        else:
            m = encode_model_step(
                imgs,
                self._delta_high,
                self._delta_low,
                split_shift,
                split_big_endian,
                low_ctx=bool(self._low_coding),
                allow_prev=self._allow_prev,
            )
            from fpv_tpu.entropy.plane_codec import encode_plane_batch

            # "wide" = const short-circuit only (1024 lanes), matching
            # the fused packager so numpy- and device-engine bytes agree
            lanes_mode = "auto" if self._narrow else "wide"

            hs = encode_plane_batch(
                m["high"].reshape(b, -1),
                np.asarray(m["hist_high"]),
                self._chunk_len,
                mask=np.asarray(m["mask_high"]),
                lanes=lanes_mode,
            )
            pvs = (
                encode_plane_batch(
                    m["preview"].reshape(b, -1),
                    np.asarray(m["hist_preview"]),
                    pv_chunk_len(self._chunk_len),
                    mask=np.asarray(m["mask_preview"]),
                    lanes=lanes_mode,
                )
                if has_pv
                else None
            )
            ls = encode_plane_batch(
                m["low"].reshape(b, -1),
                None if self._low_coding else np.asarray(m["hist_low"]),
                self._chunk_len,
                coding=self._low_coding,
                mask=(
                    None
                    if self._low_coding
                    else np.asarray(m["mask_low"])
                ),
                lanes=lanes_mode,
            )
            flags = self._pack_flags(
                np.asarray(m["use_delta"]),
                np.asarray(m["spatial"]),
                np.asarray(m["pv_spatial"]),
                np.asarray(m["nonzero_low"]),
                np.asarray(m["pv_use_delta"]),
                np.asarray(m["use_prev"]),
            )
        if timestamps is None:
            timestamps = np.full(b, -1, dtype=np.int64)
        return fpvt.serialize_batch_section(flags, timestamps, hs, ls, pvs)

    @staticmethod
    def _pack_flags(
        use_delta, spatial, pv_spatial, nonzero_low, pv_use_delta,
        use_prev=None,
    ) -> np.ndarray:
        from fpv_tpu.format.fpvt import F_PV_USE_DELTA, F_USE_PREV

        flags = (
            use_delta.astype(np.uint8) * F_USE_DELTA
            | (spatial.astype(np.uint8) << F_SPATIAL_SHIFT)
            | (~nonzero_low.astype(bool)).astype(np.uint8) * F_NO_LOW
            | (pv_spatial.astype(np.uint8) << F_PV_SPATIAL_SHIFT)
            | pv_use_delta.astype(np.uint8) * F_PV_USE_DELTA
        )
        if use_prev is not None:
            flags = flags | use_prev.astype(np.uint8) * F_USE_PREV
        return flags

    def _encode_batch_fused(
        self,
        imgs: jax.Array,
        b: int,
        split_shift: int | None = None,
        split_big_endian: bool | None = None,
    ):
        """One-jit encode; single small sync + bucketed payload pulls.

        ``split_shift``/``split_big_endian`` override the header's split
        config (plane ingest passes a left-aligned combined image with a
        shift-0 LE split); default is the header config."""
        if split_shift is None:
            split_shift = self.header.shift
        if split_big_endian is None:
            split_big_endian = self.header.big_endian
        h, w = self.header.ysize, self.header.xsize
        small_d, states_d, pay_h, pay_l, pay_p = fused_encode_batch(
            imgs,
            self._delta_high,
            self._delta_low,
            split_shift,
            split_big_endian,
            self._chunk_len,
            low_coding=self._low_coding,
            allow_prev=self._allow_prev,
        )
        return package_encoded_batch(
            np.asarray(small_d), np.asarray(states_d), pay_h, pay_l, pay_p,
            b=b, h=h, w=w, chunk_len=self._chunk_len,
            low_coding=self._low_coding,
            raw_ctx=dict(
                imgs=imgs,
                delta_high=self._delta_high,
                delta_low=self._delta_low,
                shift=split_shift,
                big_endian=split_big_endian,
            ),
        )

    def add_batch(self, section: bytes, nframes: int) -> bytes:
        """Record a section produced by :meth:`encode_batch_bytes` as the
        next batch in file order; returns the section unchanged."""
        self._batch_offsets.append((self._bytes_written, nframes))
        self._bytes_written += len(section)
        self._total_frames += nframes
        return section

    def encode_batch(
        self, imgs: np.ndarray, timestamps: np.ndarray | None = None
    ) -> bytes:
        """Encode [B, H, W] uint16 frames -> one batch section (and record it)."""
        n = np.asarray(imgs).shape[0]
        return self.add_batch(self.encode_batch_bytes(imgs, timestamps), n)

    def finish(self) -> bytes:
        return fpvt.serialize_footer(self._batch_offsets, self._total_frames)


class FpvtReader:
    """Random-access FPVT reader: batches decode as single device programs.

    ``device``: optional jax.Device pinning every program and upload of
    this reader (via a thread-local ``jax.default_device`` scope around
    each decode entry point) — independent readers on different chips
    decode concurrently (the multi-device serving axis; same-geometry
    readers still share compiled executables)."""

    def __init__(
        self, data: bytes, device=None, upload_cache: dict | None = None
    ) -> None:
        self._device = device
        # optional content-addressed staging cache for batch uploads
        # (dict, caller-owned and caller-bounded; see
        # _decode_batch_fused_issue) — share one dict across readers to
        # stage a multicast working set in HBM once
        self._upload_cache = upload_cache
        self._data = bytes(data)
        self.header = Header.parse(data)
        h, w = self.header.ysize, self.header.xsize
        # delta section follows the header
        dflags, dh_stream, dl_stream = fpvt.parse_delta_section(
            data, fpvt.HEADER_SIZE, plane_size=h * w
        )
        with self._on_device():
            dh_, dl_ = _decode_delta_planes(
                dflags, dh_stream, dl_stream, h, w
            )
            # pin on device once: raw/const delta streams decode to host
            # arrays, which would otherwise re-upload on every batch program
            self._delta_high = jnp.asarray(dh_)
            self._delta_low = jnp.asarray(dl_)
        self._batches = fpvt.parse_footer(data)
        # last chain-decoded frame's reconstructed planes:
        # (batch_index, frame_index, high u8, low u8) — lets sequential
        # decode_frame calls continue a prev chain instead of re-decoding
        # its prefix (amortized one blocks-decode per frame)
        self._chain_cache: tuple | None = None
        self._frame_to_batch: list[tuple[int, int]] = []
        if self.header.delta_is_frame0:
            # frame 0 is the delta frame itself (HDR_F_DELTA_IS_FRAME0)
            self._frame_to_batch.append((-1, 0))
        for bi, (_off, n) in enumerate(self._batches):
            for j in range(n):
                self._frame_to_batch.append((bi, j))
        self._cache: tuple[int, np.ndarray] | None = None

    def _on_device(self):
        """Scope placing this reader's uploads/programs on its pinned device
        (no-op when unpinned — default placement)."""
        if self._device is None:
            return contextlib.nullcontext()
        return jax.default_device(self._device)

    def _parse_batch(self, off: int) -> "fpvt.ParsedBatch":
        """parse_batch_section with this file's frame geometry enforced
        (crafted plane_size fields are rejected before any allocation)."""
        h, w = self.header.ysize, self.header.xsize
        return fpvt.parse_batch_section(
            self._data, off, plane_size=h * w,
            preview_size=(h // 4) * (w // 4),
        )

    def frame0(self) -> np.ndarray:
        """The synthesized first frame when the header declares the delta
        frame doubles as frame 0 (left-aligned u16, like decode_batch)."""
        return self.delta_frame()

    def delta_frame(self) -> np.ndarray:
        """The file's delta frame (left-aligned uint16 [H, W]) — the frame
        every batch's delta prediction references.  Same pixels as
        :meth:`frame0` when HDR_F_DELTA_IS_FRAME0 is set; exposed
        unconditionally for transcoding."""
        with self._on_device():
            return np.asarray(
                combine_planes(
                    self._delta_high[None], self._delta_low[None]
                )[0]
            )

    @property
    def numframes(self) -> int:
        return len(self._frame_to_batch)

    @property
    def num_batches(self) -> int:
        return len(self._batches)

    def _decode_high(self, pb: fpvt.ParsedBatch, b: int):
        h, w = self.header.ysize, self.header.xsize
        res = decode_plane_batch(pb.high).reshape(b, h, w)
        spatial = ((pb.frame_flags >> F_SPATIAL_SHIFT) & 3).astype(np.int32)
        high = _inverse_spatial(
            res,
            jnp.asarray(spatial),
            any_up=bool((spatial == SPATIAL_UP).any()),
            any_cg=bool((spatial == SPATIAL_CG2D).any()),
        )
        return high

    def _decode_parsed_batch(
        self, pb: fpvt.ParsedBatch, b: int, want_previews: bool = False
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """Decode an already-parsed batch -> (imgs u16, previews-or-None).

        The shared engine behind decode_batch and the streaming reader: one
        fused device program when the streams have device geometry, the
        per-plane path otherwise (narrow/const streams, numpy engine)."""
        from fpv_tpu import backend

        with self._on_device():
            if backend.engine() != "numpy" and _fused_decodable(
                pb, 1 << self.header.chunk_log2
            ):
                return self._decode_batch_fused(
                    pb, b, decode_preview=want_previews
                )
            return self._decode_parsed_batch_slow(pb, b, want_previews)

    def _decode_parsed_batch_issue(
        self, pb: fpvt.ParsedBatch, b: int, want_previews: bool = False,
        device_frames: bool = False, section_key=None,
    ):
        """Issue a parsed-batch decode, returning ``finalize() -> (imgs, pv)``.

        On the fused path the device program is queued immediately and only
        the pulls wait inside ``finalize`` (see _decode_batch_fused_issue);
        the fallback engines have no async split and run entirely in
        ``finalize``.  With ``device_frames`` the frames (and previews) are
        returned as device arrays left in HBM — the serving mode for
        pipelines that feed decoded frames straight into an on-device
        consumer (only the integrity scalar is pulled)."""
        from fpv_tpu import backend

        with self._on_device():
            if backend.engine() != "numpy" and _fused_decodable(
                pb, 1 << self.header.chunk_log2
            ):
                return self._decode_batch_fused_issue(
                    pb, b, decode_preview=want_previews,
                    device_frames=device_frames, section_key=section_key,
                )
        def slow():
            with self._on_device():
                imgs, pv = self._decode_parsed_batch_slow(pb, b, want_previews)
                if device_frames:
                    return jnp.asarray(imgs), (
                        jnp.asarray(pv) if pv is not None else None
                    )
                return imgs, pv
        return slow

    def _decode_parsed_batch_slow(
        self, pb: fpvt.ParsedBatch, b: int, want_previews: bool = False
    ) -> tuple[np.ndarray, np.ndarray | None]:
        h, w = self.header.ysize, self.header.xsize
        high = self._decode_high(pb, b)
        if pb.low is not None:
            low = decode_plane_batch(pb.low).reshape(b, h, w)
        else:
            low = jnp.zeros((b, h, w), jnp.uint8)
        use_delta = jnp.asarray((pb.frame_flags & F_USE_DELTA).astype(bool))
        use_prev_np = (pb.frame_flags & fpvt.F_USE_PREV).astype(bool)
        imgs = _apply_temporal_and_combine(
            high, low, use_delta, jnp.asarray(use_prev_np),
            self._delta_high, self._delta_low,
            any_prev=bool(use_prev_np.any()),
        )
        pv = self._decode_previews_parsed(pb, b) if want_previews else None
        return np.asarray(imgs), pv

    def decode_batch(self, index: int) -> np.ndarray:
        """Decode batch ``index`` -> [B, H, W] uint16 (left-aligned values)."""
        off, b = self._batches[index]
        pb = self._parse_batch(off)
        return self._decode_parsed_batch(pb, b)[0]

    def _decode_batch_fused(
        self, pb: fpvt.ParsedBatch, b: int, decode_preview: bool = False
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """One-jit decode: single upload + dispatch + frame pull."""
        return self._decode_batch_fused_issue(pb, b, decode_preview)()

    def _decode_batch_fused_issue(
        self, pb: fpvt.ParsedBatch, b: int, decode_preview: bool = False,
        device_frames: bool = False, section_key=None,
    ):
        """Upload + dispatch the fused batch decode, DEFERRING every pull.

        Returns a zero-arg ``finalize() -> (imgs, previews-or-None)``.
        Splitting issue from finalize lets a serving pipeline overlap batch
        n's frame download with batch n+1's payload upload/compute (the
        device program is already queued when finalize blocks).  With
        ``decode_preview`` the preview plane decodes inside the same fused
        program (the fast-path analog of the reference's DecodePreview,
        fusion_power_video.cc:1038-1070).

        ``device_frames``: finalize returns u16 [B,H,W] device arrays LEFT
        IN HBM (and u8 previews likewise) — only the integrity scalar is
        pulled.  When ``self._upload_cache`` is set (a dict), uploads are
        content-addressed: re-decoding a batch whose inputs are already
        staged in HBM skips the host->device transfer entirely (multicast
        serving / replay workloads)."""
        k = 1 << self.header.chunk_log2
        cache = getattr(self, "_upload_cache", None)
        staged = (
            cache.get(section_key)
            if cache is not None and section_key is not None
            else None
        )
        if staged is None:
            arrays, static = batch_decode_args(pb, k)
            names = ("payload", "plane_offs", "counts", "states", "flags",
                     "tables", "const_vals")
            key = section_key
            if cache is not None and key is None:
                # no section bytes in hand (random-access path): fall back
                # to content-addressing the built arrays
                hsh = hashlib.blake2b(digest_size=16)
                for n in names:
                    hsh.update(np.ascontiguousarray(arrays[n]))
                key = (
                    b, self.header.ysize, self.header.xsize, k,
                    tuple(sorted(static.items())), hsh.digest(),
                )
                staged = cache.get(key)
            if staged is None:
                dev = tuple(jnp.asarray(arrays[n]) for n in names)
                if cache is not None:
                    jax.block_until_ready(dev)
                    cache[key] = (
                        dev, static, b, np.asarray(pb.timestamps)
                    )
                staged = (dev, static, b, pb.timestamps)
        return self._fused_dispatch(
            staged[0], staged[1], staged[2], decode_preview, device_frames
        )

    def _fused_dispatch(
        self, dev, static: dict, b: int, decode_preview: bool,
        device_frames: bool,
    ):
        """Queue the fused decode program on staged device args; return
        ``finalize`` (see _decode_batch_fused_issue)."""
        h, w = self.header.ysize, self.header.xsize
        k = 1 << self.header.chunk_log2
        (payload_d, plane_offs_d, counts_d, states_d, flags_d, tables_d,
         const_vals_d) = dev
        out = fused_decode_batch(
            payload_d,
            plane_offs_d,
            counts_d,
            states_d,
            flags_d,
            tables_d,
            self._delta_high,
            self._delta_low,
            const_vals_d,
            chunk_len=k,
            b=b,
            h=h,
            w=w,
            decode_preview=decode_preview,
            pack_u8=not device_frames,
            **static,
        )

        def finalize() -> tuple[np.ndarray, np.ndarray | None]:
            if not bool(np.asarray(out[1])):
                raise ValueError("rANS stream integrity check failed")
            if device_frames:
                return out[0], (out[2] if decode_preview else None)
            imgs_np = np.asarray(out[0]).view("<u2").reshape(b, h, w)
            pv_np = np.asarray(out[2]) if decode_preview else None
            return imgs_np, pv_np

        return finalize

    def _staged_issue(self, section_key, want_previews: bool,
                      device_frames: bool):
        """Streaming fast path: issue a batch decode straight from staged
        device args WITHOUT parsing the section (multicast/replay serving —
        the upload cache key is the section bytes' hash).  Returns
        ``(finalize, b, timestamps)`` or None when the key is not staged.
        Per-stream state (delta planes, device pin) still comes from THIS
        reader, so identical sections in streams with different deltas stay
        independent: only the uploaded batch arrays are shared."""
        cache = getattr(self, "_upload_cache", None)
        if cache is None:
            return None
        staged = cache.get(section_key)
        if staged is None:
            return None
        dev, static, b, ts = staged
        with self._on_device():
            fin = self._fused_dispatch(
                dev, static, b, want_previews, device_frames
            )
        return fin, b, ts

    def decode_frame(self, index: int) -> np.ndarray:
        """Random-access decode of ONE frame.

        Serves from the batch cache when its batch was already decoded;
        otherwise (device engine) decodes only the rANS blocks covering the
        frame — a small fraction of a full-batch decode (the role of
        RandomAccessDecoder::DecodeFrame, fusion_power_video.cc:1017-1036).
        """
        from fpv_tpu import backend

        bi, j = self._frame_to_batch[index]
        if bi == -1:
            return self.frame0()
        if self._cache is not None and self._cache[0] == bi:
            return self._cache[1][j]
        off, b = self._batches[bi]
        pb = self._parse_batch(off)
        from fpv_tpu.ops.rans_layout import BLOCK_LANES, CODING_CONST

        k = 1 << self.header.chunk_log2
        blocks_ok = pb.low is not None and all(
            st.coding != CODING_CONST
            and st.lanes == BLOCK_LANES
            and st.chunk_len == k
            for st in (pb.high, pb.low)
        )
        # prev-frame chains: walk back to the nearest non-prev anchor; the
        # writer bounds chains to PREV_ANCHOR-1 (encoder policy), so accept
        # a small multiple and fall back to the full-batch decode beyond it
        # (foreign encoders may chain arbitrarily far)
        j0 = j
        while j0 > 0 and pb.frame_flags[j0] & fpvt.F_USE_PREV:
            j0 -= 1
        if (backend.engine() != "numpy" and blocks_ok
                and j - j0 <= 2 * PREV_ANCHOR):
            with self._on_device():
                dh, dl = self._delta_high, self._delta_low
                t0 = j0
                cc = self._chain_cache
                if cc is not None and cc[0] == bi and j0 <= cc[1] < j:
                    # resume the chain from the cached reconstruction
                    t0, dh, dl = cc[1] + 1, cc[2], cc[3]
                for t in range(t0, j + 1):
                    img = self._decode_frame_blocks(pb, b, t, dh, dl)
                    # the chain's next frame predicts against THIS frame's
                    # planes (split of the left-aligned u16)
                    dh = (img >> 8).astype(jnp.uint8)
                    dl = img.astype(jnp.uint8)
                self._chain_cache = (bi, j, dh, dl)
                return np.asarray(img)
        self._cache = (bi, self.decode_batch(bi))
        return self._cache[1][j]

    def _decode_frame_blocks(
        self, pb: fpvt.ParsedBatch, b: int, j: int,
        delta_high: jax.Array | None = None,
        delta_low: jax.Array | None = None,
    ):
        """One-dispatch decode of frame j from its covering blocks only
        -> device [H, W] u16.

        ``delta_high``/``delta_low`` override the prediction planes — the
        prev-frame chain passes the previous frame's reconstructed planes
        here, under which F_USE_PREV decodes exactly like F_USE_DELTA."""
        from fpv_tpu.entropy.plane_codec import _quantize_cap
        from fpv_tpu.ops import rans_triton as rt
        from fpv_tpu.ops.rans_layout import BLOCK_LANES, chunk_lens, num_segments

        h, w = self.header.ysize, self.header.xsize
        s = h * w
        k = 1 << self.header.chunk_log2
        span = k * BLOCK_LANES
        lens_all = chunk_lens(b, s, k).reshape(-1, BLOCK_LANES)
        nsegs = num_segments(k)

        def prep(st):
            counts = st.block_counts.astype(np.int64)
            cum = np.zeros(len(counts) + 1, np.int64)
            cum[1:] = np.cumsum(counts)
            b0 = (j * s) // span
            b1 = ((j + 1) * s - 1) // span
            nb = b1 - b0 + 1
            # counts/payload are per (block, segment) groups, block-major
            cnt = counts[b0 * nsegs : (b1 + 1) * nsegs].astype(np.int32)
            states = st.states[b0 * BLOCK_LANES : (b1 + 1) * BLOCK_LANES]
            total = int(cnt.sum())
            pay = np.zeros(_quantize_cap(total, k, nb), np.uint16)
            pay[:total] = st.payload[cum[b0 * nsegs] : cum[(b1 + 1) * nsegs]]
            table = (
                rt.ctx_fused_table(st.freq) if st.coding
                else rt.fused_table(st.freq)
            )
            return (
                jnp.asarray(pay), jnp.asarray(cnt),
                jnp.asarray(states.astype(np.uint32).reshape(nb, BLOCK_LANES)),
                jnp.asarray(lens_all[b0 : b1 + 1]),
                jnp.int32(j * s - b0 * span), jnp.asarray(table),
            )

        ph = prep(pb.high)
        pl = prep(pb.low)
        flags = int(pb.frame_flags[j])
        if delta_high is None:
            delta_high, delta_low = self._delta_high, self._delta_low
        img, ok = fused_decode_frame(
            *ph[:5], *pl[:5], ph[5], pl[5],
            delta_high, delta_low,
            chunk_len=k, h=h, w=w,
            spatial=(flags >> F_SPATIAL_SHIFT) & 3,
            use_delta=bool(flags & (F_USE_DELTA | fpvt.F_USE_PREV)),
            no_low=False,
            low_ctx=bool(pb.low.coding),
        )
        if not bool(np.asarray(ok)):
            raise ValueError("rANS stream integrity check failed")
        return img

    def decode_batch_with_previews(
        self, index: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode batch ``index`` frames AND previews.

        On the device engine both decode inside one fused device program
        (full-fidelity decode: every coded plane reconstructed)."""
        off, b = self._batches[index]
        pb = self._parse_batch(off)
        imgs, pv = self._decode_parsed_batch(pb, b, want_previews=True)
        return imgs, pv

    def preview_frame(self, index: int) -> np.ndarray:
        """Preview of ONE frame by global frame index -> [H//4, W//4] u8.

        The per-frame analog of RandomAccessDecoder::DecodePreview
        (fusion_power_video.cc:1038-1070).  When the header declares the
        delta frame doubles as frame 0, its preview is synthesized from
        the delta high plane (no preview stream exists for it)."""
        bi, j = self._frame_to_batch[index]
        if bi == -1:
            return np.asarray(
                generate_preview(self._delta_high[None])[0]
            )
        return self.decode_previews(bi)[j]

    def decode_previews(self, index: int) -> np.ndarray:
        """Decode batch ``index`` previews -> [B, H//4, W//4] uint8."""
        off, b = self._batches[index]
        pb = self._parse_batch(off)
        return self._decode_previews_parsed(pb, b)

    def _decode_previews_parsed(
        self, pb: fpvt.ParsedBatch, b: int
    ) -> np.ndarray:
        with self._on_device():
            return self._decode_previews_parsed_impl(pb, b)

    def _decode_previews_parsed_impl(
        self, pb: fpvt.ParsedBatch, b: int
    ) -> np.ndarray:
        from fpv_tpu import backend
        from fpv_tpu.format.fpvt import F_PV_USE_DELTA
        from fpv_tpu.ops.rans_layout import BLOCK_LANES, CODING_CONST

        ph, pw = self.header.ysize // 4, self.header.xsize // 4
        if pb.preview is None:
            if ph * pw == 0:
                return np.zeros((b, ph, pw), np.uint8)
            raise ValueError("batch has no preview stream")
        st = pb.preview
        # the preview stream carries its own chunk length on the wire
        # (new writers use pv_chunk_len(header chunk), see PV_CHUNK_MAX)
        k = st.chunk_len
        pv_spatial = (pb.frame_flags >> F_PV_SPATIAL_SHIFT) & 3
        any_pv_delta = bool((pb.frame_flags & F_PV_USE_DELTA).any())
        if (
            backend.engine() != "numpy"
            and st.coding != CODING_CONST
            and st.lanes == BLOCK_LANES
        ):
            # one fused program: rANS decode + inverse spatial + preview
            # delta, previews only (no main-plane work)
            from fpv_tpu.entropy.plane_codec import _quantize_cap
            from fpv_tpu.ops import rans_triton as rt

            counts = st.block_counts.astype(np.int32)
            total = int(counts.sum())
            payload = np.zeros(_quantize_cap(total, k, st.num_blocks), np.uint16)
            payload[:total] = st.payload
            pv, ok = fused_decode_preview(
                jnp.asarray(payload),
                jnp.asarray(counts),
                jnp.asarray(st.states.astype(np.uint32)),
                jnp.asarray(pb.frame_flags.astype(np.uint32)),
                jnp.asarray(rt.fused_table(st.freq)),
                self._delta_high,
                chunk_len=k,
                b=b,
                ph=ph,
                pw=pw,
                pv_any_up=bool((pv_spatial == SPATIAL_UP).any()),
                pv_any_cg=bool((pv_spatial == SPATIAL_CG2D).any()),
                any_pv_delta=any_pv_delta,
            )
            if not bool(np.asarray(ok)):
                raise ValueError("rANS stream integrity check failed")
            return np.asarray(pv)
        res = decode_plane_batch(st).reshape(b, ph, pw)
        pv = _inverse_preview(
            jnp.asarray(res),
            jnp.asarray(pb.frame_flags.astype(np.uint32)),
            self._delta_high,
            pv_any_up=bool((pv_spatial == SPATIAL_UP).any()),
            pv_any_cg=bool((pv_spatial == SPATIAL_CG2D).any()),
            any_pv_delta=any_pv_delta,
        )
        return np.asarray(pv)

    def timestamps(self, index: int) -> np.ndarray:
        off, _b = self._batches[index]
        return self._parse_batch(off).timestamps


class FpvtStreamingReader:
    """Incremental FPVT decoder: feed bytes, get frames per completed batch.

    The FPVT analog of the FPV1 StreamingDecoder (fusion_power_video.cc:
    866-956): consumes header + delta section once, then decodes every
    complete batch section as it arrives; the footer (if ever seen) ends the
    stream.  A truncated file without footer is fully streamable.

    Each complete batch decodes through the same engine as random access
    (FpvtReader._decode_parsed_batch): ONE fused device program per batch on
    the device engine — the serving path does not fall back to per-plane
    dispatches.
    """

    def __init__(
        self, callback, want_previews: bool = False, batch_hook=None,
        device=None, device_frames: bool = False,
        upload_cache: dict | None = None, content_id=None,
    ) -> None:
        """``callback(frames u16 [B,H,W], timestamps i64 [B])`` per batch;
        with ``want_previews`` the callback receives a third argument, the
        [B, H//4, W//4] u8 previews (decoded inside the same fused
        program).

        ``batch_hook(finalize, timestamps)``: pipelining hook.  When set,
        each complete batch is ISSUED to the device inside :meth:`decode`
        and the hook receives a zero-arg ``finalize() -> (imgs, pv)``
        instead of the callback firing; the owner finalizes (on another
        thread) so batch n's frame download overlaps batch n+1's upload and
        compute.  The callback is then the owner's responsibility.

        ``device``: optional jax.Device pinning this stream's programs
        (FpvtReader ``device`` semantics).

        ``device_frames``: deliver frames/previews as device arrays left in
        HBM instead of pulling them to host (see
        FpvtReader._decode_parsed_batch_issue).  ``upload_cache``: optional
        shared dict staging batch uploads in HBM by content hash.

        ``content_id``: caller-declared identity of this stream's BYTES
        (an object key, blob hash, message id...).  With an upload_cache,
        batch sections are then staged under (content_id, absolute byte
        offset) instead of a content hash — replaying a stream whose id is
        known skips the per-section hash entirely (the hash of an 88 MB
        stream otherwise costs ~ half a device decode of it).  The caller
        GUARANTEES ids name identical bytes; two different streams fed
        under one id will decode the first stream's staged batches."""
        self._callback = callback
        self._want_previews = want_previews
        self._batch_hook = batch_hook
        self._device = device
        self._device_frames = device_frames
        self._upload_cache = upload_cache
        self._content_id = content_id
        self._buffer = bytearray()
        self._inner: FpvtReader | None = None
        self._header: Header | None = None
        self._pos = 0
        self._abs_base = 0  # stream offset of buffer position 0

    def decode(self, data: bytes) -> None:
        self._buffer += data
        buf = self._buffer
        if self._inner is None:
            if len(buf) < fpvt.HEADER_SIZE + 9:
                return
            header = Header.parse(bytes(buf[: fpvt.HEADER_SIZE]))
            (dsize,) = struct.unpack_from("<Q", buf, fpvt.HEADER_SIZE)
            if len(buf) < fpvt.HEADER_SIZE + dsize:
                return
            self._header = header
            self._inner = FpvtReader.__new__(FpvtReader)
            self._inner._device = self._device
            self._inner._upload_cache = self._upload_cache
            self._inner._data = b""
            self._inner.header = header
            h, w = header.ysize, header.xsize
            dflags, dh_stream, dl_stream = fpvt.parse_delta_section(
                bytes(buf), fpvt.HEADER_SIZE, plane_size=h * w
            )
            with self._inner._on_device():
                dh_, dl_ = _decode_delta_planes(
                    dflags, dh_stream, dl_stream, h, w
                )
                # pin on device (raw/const delta streams decode to host)
                self._inner._delta_high = jnp.asarray(dh_)
                self._inner._delta_low = jnp.asarray(dl_)
            self._pos = fpvt.HEADER_SIZE + dsize
            if header.delta_is_frame0:
                frame0 = self._inner.frame0()[None]
                if self._device_frames:
                    with self._inner._on_device():
                        frame0 = jnp.asarray(frame0)
                ts0 = np.full(1, -1, dtype=np.int64)
                if self._want_previews:
                    with self._inner._on_device():
                        pv0 = generate_preview(self._inner._delta_high[None])
                        if not self._device_frames:
                            pv0 = np.asarray(pv0)
                else:
                    pv0 = None
                if self._batch_hook is not None:
                    self._batch_hook(lambda: (frame0, pv0), ts0)
                elif self._want_previews:
                    self._callback(frame0, ts0, pv0)
                else:
                    self._callback(frame0, ts0)
        while len(buf) - self._pos >= 9:
            size, stype = struct.unpack_from("<QB", buf, self._pos)
            if stype == fpvt.SECTION_INDEX:
                break  # footer: end of frames
            if len(buf) - self._pos < size:
                break  # incomplete section
            section = bytes(buf[self._pos : self._pos + size])
            hh, ww = self._header.ysize, self._header.xsize
            skey = None
            if self._upload_cache is not None:
                # section content key: a staged hit skips parsing, array
                # building AND the payload upload (multicast/replay).
                # Caller-declared stream identity replaces hashing when
                # given (same bytes -> same section offsets).
                if self._content_id is not None:
                    skey = (
                        "cid", self._content_id,
                        self._abs_base + self._pos,
                        hh, ww, self._header.chunk_log2,
                    )
                else:
                    skey = (
                        "sec",
                        hashlib.blake2b(section, digest_size=16).digest(),
                        hh, ww, self._header.chunk_log2,
                    )
                hit = self._inner._staged_issue(
                    skey, self._want_previews, self._device_frames
                )
                if hit is not None:
                    fin, _bh, ts = hit
                    if self._batch_hook is not None:
                        self._batch_hook(fin, ts)
                    else:
                        imgs, pv = fin()
                        if self._want_previews:
                            self._callback(imgs, ts, pv)
                        else:
                            self._callback(imgs, ts)
                    self._pos += size
                    continue
            pb = fpvt.parse_batch_section(
                section, 0, plane_size=hh * ww,
                preview_size=(hh // 4) * (ww // 4),
            )
            b = len(pb.frame_flags)
            if self._batch_hook is not None:
                fin = self._inner._decode_parsed_batch_issue(
                    pb, b, want_previews=self._want_previews,
                    device_frames=self._device_frames,
                    section_key=skey,
                )
                self._batch_hook(fin, pb.timestamps)
            elif self._device_frames:
                imgs, pv = self._inner._decode_parsed_batch_issue(
                    pb, b, want_previews=self._want_previews,
                    device_frames=True, section_key=skey,
                )()
                if self._want_previews:
                    self._callback(imgs, pb.timestamps, pv)
                else:
                    self._callback(imgs, pb.timestamps)
            else:
                imgs, pv = self._inner._decode_parsed_batch(
                    pb, b, want_previews=self._want_previews
                )
                if self._want_previews:
                    self._callback(imgs, pb.timestamps, pv)
                else:
                    self._callback(imgs, pb.timestamps)
            self._pos += size
        # compact consumed bytes — on EVERY exit path (steady-state
        # streaming usually leaves the loop on "incomplete section", which
        # must not skip this or the buffer retains the whole decoded
        # stream and grows without bound)
        if self._pos > 1 << 22:
            self._abs_base += self._pos
            del self._buffer[: self._pos]
            self._pos = 0


def file_encode_setup(
    frames: np.ndarray,
    shift: int,
    big_endian: bool,
    frames_per_batch: int,
    chunk_log2: int,
    delta_frame: np.ndarray | None,
    timestamps: np.ndarray | None,
):
    """Shared preamble of the file-level encoders (:func:`encode_file_fpvt`
    and parallel.mesh.sharded_encode_file): coerce + validate inputs, split
    off the delta frame (frame 0 is stored once as the delta section and
    synthesized on decode, HDR_F_DELTA_IS_FRAME0 — coding it again in batch
    0 would mix its all-zero delta residuals into the shared tables), and
    construct the writer.  Returns ``(wri, header_bytes, body, ts_body)``;
    keeping this in one place is what keeps the two paths byte-identical.

    The narrow-stream policy is decided here from the TOTAL body size (the
    rationale for narrow streams — amortizing stored chunk states — is the
    file size, not the batch size): files larger than one narrow batch
    keep every batch on the fused device path instead of paying host
    coding per batch."""
    from fpv_tpu.entropy.plane_codec import narrow_max_syms
    from fpv_tpu.ops.planes import resolve_u8_shift

    frames = np.asarray(frames)
    shift = resolve_u8_shift(frames.dtype, shift, big_endian)
    if frames.dtype != np.uint8:
        # uint8 bodies stay uint8: the device split handles them directly
        # (ops/planes.split_planes) and uploads carry half the bytes
        frames = np.asarray(frames, dtype=np.uint16)
    n, h, w = frames.shape
    if timestamps is not None:
        timestamps = np.asarray(timestamps, dtype=np.int64)
        if timestamps.shape != (n,):
            raise ValueError("timestamps must have one entry per frame")
    delta_is_frame0 = delta_frame is None
    if delta_is_frame0:
        delta_frame = frames[0]
        body = frames[1:]
        ts_body = None if timestamps is None else timestamps[1:]
    else:
        body = frames
        ts_body = timestamps
    wri = FpvtWriter(
        w, h, shift, big_endian, frames_per_batch, chunk_log2,
        delta_is_frame0=delta_is_frame0,
        narrow=body.size <= narrow_max_syms(),
    )
    return wri, wri.init(delta_frame), body, ts_body


def encode_file_fpvt(
    frames: np.ndarray,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    delta_frame: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
) -> bytes:
    """One-shot FPVT encode of [N, H, W] uint16 frames.

    ``timestamps``: optional per-frame i64 array (length N), stored in the
    batch sections and recoverable via FpvtReader.timestamps / the
    streaming callbacks.  When ``delta_frame`` is None, frame 0's
    timestamp is dropped with the frame (the synthesized frame 0 reports
    -1, like the hub's delta frames)."""
    wri, header, body, ts_body = file_encode_setup(
        frames, shift, big_endian, frames_per_batch, chunk_log2,
        delta_frame, timestamps,
    )
    parts = [header]
    # two-deep pipeline: batch n+1's upload/dispatch overlaps batch n's
    # host packaging / readbacks
    from concurrent.futures import ThreadPoolExecutor

    nb_total = body.shape[0]
    starts = list(range(0, nb_total, frames_per_batch))
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [
            pool.submit(
                wri.encode_batch_bytes,
                body[s : s + frames_per_batch],
                None if ts_body is None else ts_body[s : s + frames_per_batch],
            )
            for s in starts
        ]
        for s, f in zip(starts, futures):
            nb = min(frames_per_batch, nb_total - s)
            parts.append(wri.add_batch(f.result(), nb))
    parts.append(wri.finish())
    return b"".join(parts)


def decode_file_fpvt(data: bytes, dtype=np.uint16) -> np.ndarray:
    """One-shot FPVT decode -> [N, H, W] uint16 (left-aligned values).

    ``dtype=np.uint8`` returns the original 8-bit samples of a file
    written from uint8 frames; unlike FPV1 the header records ``shift``,
    so the request is validated against the stream."""
    from concurrent.futures import ThreadPoolExecutor

    r = FpvtReader(data)
    if np.dtype(dtype) == np.uint8:
        from fpv_tpu.ops.planes import validate_u8_config

        validate_u8_config(r.header.shift, r.header.big_endian)
    with ThreadPoolExecutor(max_workers=2) as pool:
        outs = list(pool.map(r.decode_batch, range(r.num_batches)))
    if r.header.delta_is_frame0:
        outs.insert(0, r.frame0()[None])
    out = np.concatenate(outs)
    if np.dtype(dtype) == np.uint8:
        return (out >> 8).astype(np.uint8)
    return out.astype(dtype, copy=False)


def _warmup_frames(rng, n: int, ysize: int, xsize: int, shift: int):
    """Synthetic warmup batch: iid noise plus a strong per-frame brightness
    drift, so non-anchor frames' prev-frame residual (one drift step) beats
    both the static delta (t drift steps) and no prediction — the compiled
    decode program is then the any_prev=True variant production streams
    use.  Noise keeps every residual plane non-constant."""
    # int64 arithmetic: maxv = 65536 at shift=0 overflows uint16 scalars
    # under NumPy 2, and tiny sample ranges (shift >= 11) need the floors
    maxv = 1 << (16 - shift)
    noise = rng.integers(0, max(maxv // 64, 1), (n, ysize, xsize), np.int64)
    drift = (np.arange(n, dtype=np.int64) * max(maxv // 16, 1)) % maxv
    return ((noise + drift[:, None, None]) % maxv).astype(np.uint16)


def warmup_stream(
    xsize: int,
    ysize: int,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    device=None,
    decode: bool = True,
    previews: bool = False,
    mesh=None,
) -> None:
    """Pre-compile the fused encode (and decode) programs for a stream
    geometry before traffic arrives.

    ``mesh``: optionally also warm the sharded whole-file programs
    (parallel.mesh.sharded_encode_file / sharded_decode_file) for this
    geometry over the given jax.sharding.Mesh — multi-chip pipelines pay
    their own compiles.

    Kernel compiles cost seconds to tens of seconds on a cold host; a serving
    process (MultiStreamEncoder/MultiStreamDecoder, FpvtStreamingReader)
    that warms each camera geometry at startup serves its first real batch
    at steady-state latency.  Same-geometry streams share compiled
    executables, so one warmup covers every stream of that shape on the
    device.

    Synthetic drifting-noise frames drive the production program shapes:
    per-frame noise defeats the CODING_CONST short-circuit, and a slow
    brightness drift makes non-anchor frames pick prev-frame prediction so
    the decode program compiled here is the any_prev=True variant real
    temporally-correlated streams hit (compiled decode programs are
    additionally specialized on the per-batch predictor-decision flags, so
    content whose decisions differ — e.g. a batch where NO frame picked
    prev — may still pay one smaller re-compile).
    """
    rng = np.random.default_rng(0)
    frames = _warmup_frames(rng, frames_per_batch + 1, ysize, xsize, shift)
    wri = FpvtWriter(
        xsize, ysize, shift, big_endian, frames_per_batch, chunk_log2,
        device=device, narrow=False,
    )
    parts = [wri.init(frames[0])]
    parts.append(wri.encode_batch(frames[1:]))
    parts.append(wri.finish())
    if not decode:
        return
    rdr = FpvtReader(b"".join(parts), device=device)
    if previews:
        rdr.decode_batch_with_previews(0)
    else:
        rdr.decode_batch(0)
    if mesh is not None:
        from fpv_tpu.parallel.mesh import (
            sharded_decode_file,
            sharded_encode_file,
        )

        ndev = mesh.shape["data"]
        n = ndev * frames_per_batch
        mframes = _warmup_frames(rng, n + 1, ysize, xsize, shift)
        mdata = sharded_encode_file(
            mframes, mesh, shift=shift, big_endian=big_endian,
            frames_per_batch=frames_per_batch, chunk_log2=chunk_log2,
        )
        if decode:
            sharded_decode_file(mdata, mesh, want_previews=previews)
