"""Per-plane-batch rANS stream codec: engine dispatch + host packaging.

One ``PlaneStream`` holds the entropy-coded bytes of one byte plane across a
whole batch of frames, sharing a single frequency table.  The stream layout
is the block-interleaved "step-major descending" format of
fpv_tpu.ops.rans_layout.

Engines (fpv_tpu.backend.engine chooses; a caller may name one):
* ``gpu`` / ``interpret`` — the GPU kernels (fpv_tpu.ops.rans_triton),
  compiled on a GPU or, on request, run in the Pallas interpreter;
* ``numpy`` — the vectorized host engine (fpv_tpu.ops.rans_numpy), used on
  CPU and as the bit-exact oracle.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from fpv_tpu import backend
from fpv_tpu.entropy.tables import normalize_freqs, normalize_freqs_ctx
from fpv_tpu.ops import rans_numpy
from fpv_tpu.ops.rans_layout import (
    BLOCK_LANES,
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
    CTX_ALPHA,
    CTX_NIDX,
    CTX_PROB_BITS,
    LANES_MIN,
    chunk_lens,
)

DEFAULT_CHUNK_LEN = 512

# Narrow-stream encoder policy (see rans_layout LANES_MIN): plane batches of
# at most this many symbols store fewer chunk states by using fewer lanes
# (each 1024-lane block costs ~3 KB of stored states).  Narrow streams are
# coded by the host engine (the device kernels are 1024-lane), so the cap
# also bounds the host coding cost per plane.  Overridable via the
# FPV_TPU_NARROW_MAX env knob (0 disables narrow streams entirely — used by
# tests that pin the device geometry on tiny planes).
NARROW_MAX_SYMS = 4 << 20


def narrow_max_syms() -> int:
    env = os.environ.get("FPV_TPU_NARROW_MAX")
    return int(env) if env is not None else NARROW_MAX_SYMS


# Longest chunk a narrow stream may use (bounds host coding latency and the
# per-(block, segment) count array; the format itself allows up to 65536).
NARROW_MAX_K = 32768


def _narrow_geometry(n: int) -> tuple[int, int]:
    """(lanes, stream chunk_len) for a small plane batch of n symbols.

    Narrow streams pick their own chunk length (one chunk spanning the
    whole lane where possible) — the caller's requested chunk_len is
    deliberately not honored here."""
    lanes = LANES_MIN
    while lanes < BLOCK_LANES and -(-n // lanes) > NARROW_MAX_K:
        lanes *= 2
    k = max(16, 1 << max(0, (-(-n // lanes)) - 1).bit_length())
    return lanes, min(k, NARROW_MAX_K)


@dataclasses.dataclass
class PlaneStream:
    """Entropy-coded plane batch (host representation, maps 1:1 to container)."""

    nframes: int
    plane_size: int  # S = bytes per frame plane
    chunk_len: int  # K
    freq: np.ndarray  # [256] u16 (coding=0) or [512] per-ctx u16 (coding=1)
    states: np.ndarray  # [C] u32 (real chunks only)
    block_counts: np.ndarray  # [nblocks * nseg] u32, (block, segment) groups
    payload: np.ndarray  # [sum(block_counts)] u16
    coding: int = CODING_ORDER0  # CODING_CTX16: nibble alphabet, ctx tables
    lanes: int = BLOCK_LANES  # chunks (= parallel rANS streams) per block

    @property
    def num_blocks(self) -> int:
        from fpv_tpu.ops.rans_layout import num_blocks

        if self.lanes == 0:  # CONST/RAW streams carry no chunk structure
            return 0
        return num_blocks(
            self.nframes, self.plane_size, self.chunk_len, self.lanes
        )

    @property
    def num_chunks(self) -> int:
        return self.num_blocks * self.lanes

    @property
    def num_groups(self) -> int:
        from fpv_tpu.ops.rans_layout import num_segments

        return self.num_blocks * num_segments(self.chunk_len)

    @property
    def value(self) -> int:
        """The constant byte of a CODING_CONST stream."""
        return int(self.freq[0])

    @property
    def raw_bytes(self) -> np.ndarray:
        """The stored bytes of a CODING_RAW stream (u8, [nframes*plane_size])."""
        n = self.nframes * self.plane_size
        return self.payload.view(np.uint8)[:n]


def raw_plane_stream(
    nframes: int, plane_size: int, chunk_len: int, data: np.ndarray
) -> PlaneStream:
    """A CODING_RAW stream: the plane-batch residual bytes stored verbatim
    (packed little-endian into the u16 payload array; odd sizes pad one
    byte that never serializes)."""
    b = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if b.size != nframes * plane_size:
        raise ValueError("raw plane data size mismatch")
    if b.size % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return PlaneStream(
        nframes=nframes,
        plane_size=plane_size,
        chunk_len=chunk_len,
        freq=np.zeros(0, np.uint16),
        states=np.zeros(0, np.uint32),
        block_counts=np.zeros(0, np.uint32),
        payload=b.view("<u2"),
        coding=CODING_RAW,
        lanes=0,
    )


def raw_policy_enabled() -> bool:
    """CODING_RAW encoder policy switch (FPV_TPU_RAW=0 disables — A/B and
    byte-stability against pre-v6 writer behavior)."""
    return os.environ.get("FPV_TPU_RAW", "1") != "0"


def raw_stream_bytes(n: int) -> int:
    """Serialized size of a CODING_RAW stream of n plane-batch bytes."""
    size = 24 + n
    return size + (-size) % 8


def coded_stream_bytes(num_chunks: int, num_groups: int, total_words: int) -> int:
    """Serialized size of an order-0/ctx16 rANS stream (exact twin of
    format.fpvt.serialize_plane_stream's layout — the raw-vs-coded decision
    compares these BEFORE materializing either byte string)."""
    size = 24 + 512 + 4 * num_chunks + 4 * num_groups + 2 * total_words
    return size + (-size) % 8


def _maybe_raw(ps: PlaneStream, plane, allow_raw: bool) -> PlaneStream:
    """Encoder policy: replace a coded stream with a CODING_RAW store of the
    input residual bytes whenever that is not larger (ties go to raw — same
    bytes, no decode kernel).  ``plane`` is the [B, S] residual the stream
    was coded from."""
    if (
        not allow_raw
        or not raw_policy_enabled()
        or ps.coding not in (CODING_ORDER0, CODING_CTX16)
    ):
        return ps
    n = ps.nframes * ps.plane_size
    coded = coded_stream_bytes(
        ps.num_chunks, ps.num_groups, int(ps.payload.size)
    )
    if raw_stream_bytes(n) <= coded:
        return raw_plane_stream(
            ps.nframes, ps.plane_size, ps.chunk_len, np.asarray(plane)
        )
    return ps


def const_plane_stream(
    nframes: int, plane_size: int, chunk_len: int, value: int
) -> PlaneStream:
    """A CODING_CONST stream: the whole plane batch is the byte ``value``."""
    return PlaneStream(
        nframes=nframes,
        plane_size=plane_size,
        chunk_len=chunk_len,
        freq=np.array([value], np.uint16),
        states=np.zeros(0, np.uint32),
        block_counts=np.zeros(0, np.uint32),
        payload=np.zeros(0, np.uint16),
        coding=CODING_CONST,
    )


# ---------------------------------------------------------------------------
# device-side layout shuffles (jitted, static shapes)


@functools.partial(jax.jit, static_argnames=("chunk_len", "nblocks"))
def _to_block_symbols(plane: jax.Array, chunk_len: int, nblocks: int):
    """[B, S] u8 -> [nblocks, K, 1024] u8 — a pure reshape.

    With the interleaved lane layout (fpv_tpu.ops.rans_layout.chunk_lens),
    the step-major array IS the flat symbol stream: no transposes on device.
    """
    flat = plane.reshape(-1).astype(jnp.uint8)
    pad = nblocks * chunk_len * BLOCK_LANES - flat.shape[0]
    if pad:
        flat = jnp.pad(flat, (0, pad))
    return flat.reshape(nblocks, chunk_len, BLOCK_LANES)


@functools.partial(
    jax.jit, static_argnames=("nframes", "plane_size", "chunk_len")
)
def _from_block_symbols(
    syms: jax.Array, nframes: int, plane_size: int, chunk_len: int
):
    """[nblocks, K, 1024] u8 -> [B, S] u8 (pure reshape)."""
    flat = syms.reshape(-1)[: nframes * plane_size]
    return flat.reshape(nframes, plane_size).astype(jnp.uint8)


def ctx_combine_device(prev: jax.Array, sym4: jax.Array) -> jax.Array:
    """(previous-step symbols, symbols) [nb, K', 1024] -> fc indices
    ctx*16+sym (ctx feature defined in fpv_tpu.ops.rans_layout)."""
    p = prev.astype(jnp.int32)
    al = jnp.roll(p, 1, axis=2)
    ar = jnp.roll(p, -1, axis=2)
    ctx = p * 2 + (al != ar).astype(jnp.int32)
    return ctx * CTX_ALPHA + sym4.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def ctx_indices_device(sym4: jax.Array) -> jax.Array:
    """[nb, K, 1024] nibble symbols (zero-padded) -> fc indices
    ctx*16+sym, the device twin of rans_numpy.encode_ctx_indices (ctx
    feature defined in fpv_tpu.ops.rans_layout)."""
    nb = sym4.shape[0]
    s = sym4.astype(jnp.int32)
    prev = jnp.concatenate(
        [jnp.zeros((nb, 1, BLOCK_LANES), jnp.int32), s[:, :-1]], axis=1
    )
    return ctx_combine_device(prev, s)


def ctx_presence_device(sym4: jax.Array) -> jax.Array:
    """[512] 0/1 exact presence of (ctx, sym) pairs over ALL symbols.

    Bitmap OR-reduction (16 u32 words of 32 bits): ~32 vector ops/element,
    one streaming pass — the whole expression (prev shift, lane rolls, ctx
    combine, select, OR-reduce) fuses, so no full-size index array
    materializes.  Exactness lets ctx-table floors skip absent pairs
    (tables.normalize_freqs_ctx floor_mask): a blanket 16-symbol floor at
    scale 128 costs 0.18 bits/symbol on deterministic conditionals."""
    idx = ctx_indices_device(sym4)
    v = idx.reshape(-1).astype(jnp.uint32)
    pad = (-v.shape[0]) % 512
    if pad:
        v = jnp.concatenate([v, jnp.zeros(pad, jnp.uint32)])
        # padding contributes idx 0 = (ctx 0, sym 0), which real step-0
        # zero-padding already makes present; harmless superset either way
    v2 = v.reshape(-1, 512)
    bit = jnp.left_shift(jnp.uint32(1), v2 & 31)
    word = v2 >> 5  # 0..15
    rows = []
    for w in range(CTX_NIDX // 32):
        m = jnp.where(word == w, bit, jnp.uint32(0))
        rows.append(
            jax.lax.reduce(m, jnp.uint32(0), jax.lax.bitwise_or, (0, 1))
        )
    words = jnp.stack(rows)  # [16] u32
    bits = (words[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :]) & 1
    return bits.reshape(CTX_NIDX).astype(jnp.int32)


def _interleave_np(
    plane_np: np.ndarray, chunk_len: int, nblocks: int,
    lanes: int = BLOCK_LANES,
):
    """Host-side [B, S] u8 -> [C, K] per-lane symbols for the numpy engine."""
    flat = plane_np.reshape(-1)
    pad = nblocks * chunk_len * lanes - flat.size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    return (
        flat.reshape(nblocks, chunk_len, lanes)
        .transpose(0, 2, 1)
        .reshape(nblocks * lanes, chunk_len)
    )


def _deinterleave_np(
    symbols: np.ndarray, n: int, chunk_len: int, lanes: int = BLOCK_LANES
):
    """Inverse of :func:`_interleave_np`: [C, K] -> flat [n]."""
    c, k = symbols.shape
    nblocks = c // lanes
    flat = (
        symbols.reshape(nblocks, lanes, k)
        .transpose(0, 2, 1)
        .reshape(-1)
    )
    return flat[:n]


def _quantize_window(max_count: int, chunk_len: int) -> int:
    """Round a per-group word count up to one of a few buckets, to limit
    distinct compile shapes.

    Groups are (block, segment) regions, so the worst case is one word
    per symbol of one segment, not of the full chunk."""
    from fpv_tpu.ops.rans_layout import SEG_LEN

    worst = min(chunk_len, SEG_LEN) * BLOCK_LANES
    step = max(worst // 8, 2048)
    return min(-(-max_count // step) * step, worst)


def _quantize_cap(total_words: int, chunk_len: int, nblocks: int) -> int:
    """Payload capacity bucket (multiple of worst/32) for static shapes."""
    worst = chunk_len * BLOCK_LANES * nblocks
    step = max(worst // 32, 4096)
    return max(step, -(-total_words // step) * step)


@functools.partial(jax.jit, static_argnames=("cap", "win"))
def _compact_payload(
    words: jax.Array, cum: jax.Array, cap: int, win: int
) -> jax.Array:
    """Concatenate ragged per-group word regions into one tight u16 buffer.

    ``words`` is [ngroups, L]; group m's words sit at the start of its row,
    so the concat is ngroups contiguous copies: group m's first ``win``
    words are placed at offset cum[m]; group m+1's copy starts exactly at
    cum[m] + count_m and overwrites m's padding garbage.
    """
    ngroups = words.shape[0]
    words = words.astype(jnp.uint16)

    # fori_loop keeps the buffer carry in place (an unrolled
    # dynamic_update_slice chain materializes full-buffer copies); several
    # groups per iteration amortize the loop's per-step overhead
    unroll = 16

    def body(i, out):
        for s in range(unroll):
            # clamp: the tail re-places the last group at its own offset
            # (identical bytes, idempotent)
            m = jnp.minimum(i * unroll + s, ngroups - 1)
            chunk = jax.lax.dynamic_slice(words, (m, 0), (1, win))[0]
            out = jax.lax.dynamic_update_slice(out, chunk, (cum[m],))
        return out

    out = jax.lax.fori_loop(
        0, -(-ngroups // unroll), body, jnp.zeros(cap + win, jnp.uint16)
    )
    return out[:cap]


# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("nbins",))
def _hist_flat(x: jax.Array, nbins: int) -> jax.Array:
    """Exact histogram of a flat int array via compare-reduce."""
    n = x.shape[0]
    width = 512
    pad = (-n) % width
    if pad:
        x = jnp.concatenate([x, jnp.full(pad, -1, jnp.int32)])
    x2 = x.reshape(-1, width)
    bins = jnp.arange(nbins, dtype=jnp.int32)
    eq = x2[:, :, None] == bins[None, None, :]
    return jnp.sum(eq, axis=(0, 1), dtype=jnp.int32)


def _package_device(
    states_d, words_d, counts_d, b, s, chunk_len, nblocks, freq,
    coding=CODING_ORDER0,
) -> PlaneStream:
    """Host packaging of device encode outputs (counts sync + compaction)."""
    counts = np.asarray(counts_d).reshape(-1)  # [nblocks * nseg] groups
    total = int(counts.sum())
    cap = _quantize_cap(total, chunk_len, nblocks)
    win = _quantize_window(int(counts.max()) if len(counts) else 0, chunk_len)
    cum = np.zeros(len(counts) + 1, np.int32)
    cum[1:] = np.cumsum(counts)
    payload_d = _compact_payload(words_d, jnp.asarray(cum), cap, win)
    payload = np.asarray(payload_d)[:total]
    states = np.asarray(states_d).reshape(-1)
    return PlaneStream(
        nframes=b, plane_size=s, chunk_len=chunk_len, freq=freq,
        states=states, block_counts=counts.astype(np.uint32),
        payload=payload, coding=coding,
    )


def encode_plane_batch(
    plane,
    hist: np.ndarray | None,
    chunk_len: int = DEFAULT_CHUNK_LEN,
    engine: str | None = None,
    coding: int = CODING_ORDER0,
    mask: np.ndarray | None = None,
    lanes: int | str | None = None,
    allow_raw: bool | None = None,
) -> PlaneStream:
    """Encode a [B, S] (or [B, H, W]) uint8 plane batch.

    ``hist`` is the 256-bin histogram of the whole batch (device-computed;
    passed in so callers can fuse histogramming with prediction);
    ``mask`` an optional exact-support superset (see
    tables.normalize_freqs floor_mask).  With ``coding=CODING_CTX16``
    (nibble alphabet + conditional tables, see rans_layout) the joint
    (ctx, sym) histogram is computed here exactly and ``hist`` may be None.

    ``lanes="auto"`` applies the encoder policy: constant plane batches
    short-circuit to a CODING_CONST stream, and small batches
    (<= narrow_max_syms()) become narrow streams with fewer stored chunk
    states (host-coded, possibly with a longer stream chunk_len).
    ``lanes="wide"`` applies only the const short-circuit and keeps the
    1024-lane device geometry — what writers with the narrow policy
    disabled use, so their bytes match the fused device path.  The
    default (None) and explicit lane counts pin the geometry (1024 = the
    device-kernel layout) and never change coding or chunk_len — tests and
    kernel callers rely on that.

    ``allow_raw`` (default: on exactly for the policy modes "auto"/"wide")
    replaces the coded stream with a CODING_RAW store whenever that is not
    larger (incompressible planes; see rans_layout.CODING_RAW).
    """
    engine = engine or backend.engine()
    b = plane.shape[0]
    if hasattr(plane, "reshape"):
        plane = plane.reshape(b, -1)
    s = plane.shape[1]
    n = b * s
    auto = lanes in ("auto", "wide")
    if allow_raw is None:
        allow_raw = auto
    if auto:
        if lanes == "auto" and 0 < n <= narrow_max_syms():
            lanes, chunk_len = _narrow_geometry(n)
        else:
            lanes = BLOCK_LANES
    elif lanes is None:
        lanes = BLOCK_LANES
    if lanes != BLOCK_LANES:
        engine = "numpy"  # the device kernels are 1024-lane only
    if auto and n:
        if engine == "numpy" or isinstance(plane, np.ndarray):
            plane = np.asarray(plane)
            if (plane == plane.flat[0]).all():
                return const_plane_stream(b, s, chunk_len, int(plane.flat[0]))
        else:
            # device array staying on device ("wide" fused-adjacent path):
            # reduce there — syncing one scalar beats pulling the whole
            # batch to host and re-uploading it
            first = jnp.ravel(plane)[0]
            if bool(jnp.all(plane == first)):
                return const_plane_stream(b, s, chunk_len, int(first))
    lens = chunk_lens(b, s, chunk_len, lanes)
    nblocks = len(lens) // lanes

    if coding == CODING_CTX16:
        from fpv_tpu.ops import rans_numpy as rn

        if engine == "numpy":
            sym4 = (
                _interleave_np(np.asarray(plane), chunk_len, nblocks, lanes)
                >> 4
            ).astype(np.uint8)
            idx = rn.encode_ctx_indices(sym4, lens, lanes)
            mask = np.arange(chunk_len)[None, :] < lens[:, None]
            jhist = np.bincount(idx[mask].reshape(-1), minlength=CTX_NIDX)
            # lens-masked hist is exact: floor only pairs that occur
            freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
            _f32, cum, _sos = rn.ctx_tables(freq)
            states, counts, payload = rn.encode_blocks(
                idx, lens, freq, prob_bits=CTX_PROB_BITS, cum=cum,
                lanes=lanes,
            )
            return _maybe_raw(
                PlaneStream(
                    nframes=b, plane_size=s, chunk_len=chunk_len, freq=freq,
                    states=states, block_counts=counts, payload=payload,
                    coding=CODING_CTX16, lanes=lanes,
                ),
                plane, allow_raw,
            )
        from fpv_tpu.ops import rans_triton as rt

        sym4 = _to_block_symbols(
            jnp.asarray(plane) >> 4, chunk_len, nblocks
        )
        idx = ctx_indices_device(sym4)
        jhist = np.asarray(_hist_flat(idx.reshape(-1), CTX_NIDX))
        # full-index hist is an exact-support superset (padding included):
        # floor only pairs that can occur
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        states_d, words_d, counts_d = rt.encode(
            sym4, jnp.asarray(lens), jnp.asarray(rt.ctx_encode_table(freq)),
            chunk_len, prob_bits=CTX_PROB_BITS, ctx_mode=True,
            interpret=backend.interpret(),
        )
        return _maybe_raw(
            _package_device(
                states_d, words_d, counts_d, b, s, chunk_len, nblocks, freq,
                coding=CODING_CTX16,
            ),
            plane, allow_raw,
        )

    if engine == "numpy" and hist is None:
        # narrow-policy reroutes may not carry a device histogram; the
        # plane is already host-side, so an exact bincount is cheap
        hist = np.bincount(
            np.asarray(plane).reshape(-1), minlength=256
        )
        mask = hist > 0
    freq = normalize_freqs(np.asarray(hist), ensure_all=True, floor_mask=mask)

    if engine == "numpy":
        flat = _interleave_np(np.asarray(plane), chunk_len, nblocks, lanes)
        states, counts, payload = rans_numpy.encode_blocks(
            flat, lens, freq, lanes=lanes
        )
        return _maybe_raw(
            PlaneStream(
                nframes=b, plane_size=s, chunk_len=chunk_len, freq=freq,
                states=states, block_counts=counts, payload=payload,
                lanes=lanes,
            ),
            plane, allow_raw,
        )

    from fpv_tpu.ops import rans_triton as rt

    syms = _to_block_symbols(jnp.asarray(plane), chunk_len, nblocks)
    states_d, words_d, counts_d = rt.encode(
        syms, jnp.asarray(lens), jnp.asarray(rt.encode_table(freq)),
        chunk_len, interpret=backend.interpret(),
    )
    return _maybe_raw(
        _package_device(
            states_d, words_d, counts_d, b, s, chunk_len, nblocks, freq
        ),
        plane, allow_raw,
    )


def decode_plane_batch(
    stream: PlaneStream, check: bool = True, engine: str | None = None
):
    """Decode a PlaneStream -> [B, S] uint8 (device array on the device
    engine)."""
    engine = engine or backend.engine()
    b, s, k = stream.nframes, stream.plane_size, stream.chunk_len
    if stream.coding == CODING_CONST:
        return np.full((b, s), stream.value, np.uint8)
    if stream.coding == CODING_RAW:
        return stream.raw_bytes.reshape(b, s)
    if stream.lanes != BLOCK_LANES:
        engine = "numpy"  # narrow streams are host-coded
    lens = chunk_lens(b, s, k, stream.lanes)
    states = stream.states.astype(np.uint32)
    ctx = stream.coding == CODING_CTX16

    if engine == "numpy":
        if ctx:
            syms, ok = rans_numpy.decode_blocks_ctx(
                states, stream.block_counts, stream.payload, lens,
                stream.freq, k, lanes=stream.lanes,
            )
            syms = (syms << 4).astype(np.uint8)
        else:
            syms, ok = rans_numpy.decode_blocks(
                states, stream.block_counts, stream.payload, lens,
                stream.freq, k, lanes=stream.lanes,
            )
        if check and not ok.all():
            raise ValueError("rANS stream integrity check failed")
        return _deinterleave_np(syms, b * s, k, stream.lanes).reshape(b, s)

    from fpv_tpu.ops import rans_triton as rt

    nblocks = len(lens) // BLOCK_LANES
    counts = stream.block_counts.astype(np.int32)
    starts = np.zeros(len(counts), np.int32)
    starts[1:] = np.cumsum(counts)[:-1]
    # bucket the payload length so streams share compiled programs
    payload = np.zeros(_quantize_cap(int(counts.sum()), k, nblocks), np.uint16)
    payload[: stream.payload.size] = stream.payload
    table = rt.ctx_fused_table(stream.freq) if ctx else rt.fused_table(
        stream.freq
    )
    syms, ok = rt.decode(
        jnp.asarray(counts), jnp.asarray(starts), jnp.asarray(payload),
        jnp.asarray(states.reshape(nblocks, BLOCK_LANES)), jnp.asarray(lens),
        jnp.asarray(table), k,
        prob_bits=CTX_PROB_BITS if ctx else 12, ctx_mode=ctx,
        interpret=backend.interpret(),
    )
    if check and not bool(jnp.all(ok == 1)):
        raise ValueError("rANS stream integrity check failed")
    out = _from_block_symbols(syms, b, s, k)
    return (out << 4).astype(jnp.uint8) if ctx else out
