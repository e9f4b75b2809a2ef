"""GPU kernels for the block-interleaved rANS coder (Pallas through Triton).

One program codes one 1024-lane block (the wire format's block,
fpv_tpu.ops.rans_layout) through all K symbol steps, so each lane's rANS
state stays in registers for the whole chunk.  Per step:

* table entries come from indexed loads of a small packed table (1-16 KB,
  L1-resident);
* a block-wide ``cumsum`` of the renormalization mask ranks the lanes that
  emit (encode) or consume (decode) a word, which puts each step's word
  group in row-major lane order;
* the encoder stores its group with a masked indexed store at
  ``ptr + rank``; the decoder loads its group with a masked indexed load
  from the compact payload.

Segments (``SEG_LEN`` steps) survive only as the format's per-(block,
segment) word regions and counts: the kernel restarts its word pointer at
each segment boundary.  In context mode (``ctx_mode``) the lane-neighbour
context is computed in the program from the previous step's symbols: the
encoder reads them from its input, the decoder from the symbols it has
already written (a block barrier orders the two).

The stream matches fpv_tpu.ops.rans_numpy bit for bit.  The kernels run
compiled on a GPU; ``interpret=True`` runs them in the Pallas interpreter
(CPU tests), which the caller must ask for (fpv_tpu.backend).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fpv_tpu.ops.rans_layout import (
    BLOCK_LANES,
    CTX_ALPHA,
    CTX_PROB_BITS,
    CTX_PROB_SCALE,
    PROB_BITS,
    PROB_SCALE,
    RANS_L,
    SEG_LEN,
    num_segments,
)

NUM_WARPS = 8


def _segments(chunk_len: int) -> tuple[int, int]:
    kseg = min(chunk_len, SEG_LEN)
    nseg = num_segments(chunk_len)
    if nseg * kseg != chunk_len:
        raise ValueError("chunk_len > SEG_LEN must be a SEG_LEN multiple")
    return kseg, nseg


def words_len(chunk_len: int) -> int:
    """Encoder staging words per (block, segment): one word per symbol at
    worst, plus a lane-indexed tail that non-emitting lanes address (so no
    two lanes of a masked store share an index, which the interpreter's
    read-modify-write store needs)."""
    return (min(chunk_len, SEG_LEN) + 1) * BLOCK_LANES


def _barrier(interpret: bool) -> None:
    if not interpret:
        plgpu.debug_barrier()


def _ctx_of(prev: jax.Array, al: jax.Array, ar: jax.Array) -> jax.Array:
    """ctx = a*2 + (al != ar) (rans_layout CTX docs)."""
    return prev * 2 + (al != ar).astype(jnp.int32)


def _encode_kernel(
    syms_ref, lens_ref, fc_ref, states_ref, words_ref, counts_ref,
    *, chunk_len: int, prob_bits: int, ctx_mode: bool,
):
    m = pl.program_id(0)
    kseg, nseg = _segments(chunk_len)
    lane = jnp.arange(BLOCK_LANES, dtype=jnp.int32)
    left = (lane - 1) & (BLOCK_LANES - 1)
    right = (lane + 1) & (BLOCK_LANES - 1)
    trash = kseg * BLOCK_LANES + lane
    lens = plgpu.load(lens_ref.at[m, lane])
    fmask = (1 << prob_bits) - 1
    renorm_shift = 31 - prob_bits

    def segment(gi, x):
        g = nseg - 1 - gi  # rANS encodes in reverse: last segment first
        grp = m * nseg + g

        def step(t, carry):
            x, ptr = carry
            j = g * kseg + (kseg - 1 - t)
            sym = plgpu.load(syms_ref.at[m, j, lane]).astype(jnp.int32)
            if ctx_mode:
                jp = jnp.maximum(j - 1, 0)
                first = j == 0
                prev = plgpu.load(syms_ref.at[m, jp, lane])
                al = plgpu.load(syms_ref.at[m, jp, left])
                ar = plgpu.load(syms_ref.at[m, jp, right])
                ctx = _ctx_of(prev.astype(jnp.int32), al, ar)
                sym = jnp.where(first, 0, ctx) * CTX_ALPHA + sym
            e = plgpu.load(fc_ref.at[sym])
            active = j < lens
            f = jnp.where(active, (e & fmask) + 1, 1)
            emit = active & (x >= (f << renorm_shift))
            e32 = emit.astype(jnp.int32)
            incl = jnp.cumsum(e32)
            pos = jnp.where(emit, ptr + incl - e32, trash)
            plgpu.store(
                words_ref.at[grp, pos], (x & 0xFFFF).astype(jnp.uint16),
                mask=emit,
            )
            x2 = jnp.where(emit, x >> 16, x)
            q = x2 // f
            xn = (q << prob_bits) + (x2 - q * f) + (e >> prob_bits)
            return jnp.where(active, xn, x), ptr + jnp.sum(e32)

        x, ptr = jax.lax.fori_loop(0, kseg, step, (x, jnp.int32(0)))
        plgpu.store(counts_ref.at[grp], ptr)
        return x

    x0 = jnp.full((BLOCK_LANES,), RANS_L, jnp.uint32)
    x = jax.lax.fori_loop(0, nseg, segment, x0)
    plgpu.store(states_ref.at[m, lane], x)


def _decode_kernel(
    counts_ref, starts_ref, payload_ref, states_ref, lens_ref, tab_ref,
    out_ref, ok_ref,
    *, chunk_len: int, prob_bits: int, ctx_mode: bool, interpret: bool,
):
    m = pl.program_id(0)
    kseg, nseg = _segments(chunk_len)
    lane = jnp.arange(BLOCK_LANES, dtype=jnp.int32)
    left = (lane - 1) & (BLOCK_LANES - 1)
    right = (lane + 1) & (BLOCK_LANES - 1)
    lens = plgpu.load(lens_ref.at[m, lane])
    x0 = plgpu.load(states_ref.at[m, lane])
    npay = payload_ref.shape[0]
    scale = 1 << prob_bits
    fmask = scale - 1
    # fused table entry = off << (sb + pb) | (f-1) << sb | sym
    sym_bits = 4 if ctx_mode else 8

    def segment(g, carry):
        x, prev, seg_ok = carry
        grp = m * nseg + g
        ptr0 = plgpu.load(counts_ref.at[grp])
        start = plgpu.load(starts_ref.at[grp])

        def step(jl, carry):
            x, ptr, prev = carry
            j = g * kseg + jl
            active = j < lens
            slot = (x & fmask).astype(jnp.int32)
            if ctx_mode:
                jp = jnp.maximum(j - 1, 0)
                nb = j > 0
                al = plgpu.load(out_ref.at[m, jp, left], mask=nb, other=0)
                ar = plgpu.load(out_ref.at[m, jp, right], mask=nb, other=0)
                slot = _ctx_of(prev, al, ar) * scale + slot
            e = plgpu.load(tab_ref.at[slot])
            sym = (e & ((1 << sym_bits) - 1)).astype(jnp.int32)
            f = ((e >> sym_bits) & fmask) + 1
            xn = f * (x >> prob_bits) + (e >> (sym_bits + prob_bits))
            renorm = active & (xn < RANS_L)
            r32 = renorm.astype(jnp.int32)
            incl = jnp.cumsum(r32)
            base = ptr - jnp.sum(r32)
            idx = start + base + incl - r32
            ok_idx = renorm & (idx >= 0) & (idx < npay)
            w = plgpu.load(
                payload_ref.at[jnp.clip(idx, 0, npay - 1)], mask=ok_idx,
                other=0,
            ).astype(jnp.uint32)
            x = jnp.where(active, jnp.where(renorm, (xn << 16) | w, xn), x)
            prev = jnp.where(active, sym, 0)
            plgpu.store(out_ref.at[m, j, lane], prev.astype(jnp.uint8))
            if ctx_mode:
                # the next step reads its neighbours' symbols back
                _barrier(interpret)
            return x, base, prev

        x, ptr, prev = jax.lax.fori_loop(0, kseg, step, (x, ptr0, prev))
        return x, prev, seg_ok & (ptr == 0)

    x, _prev, seg_ok = jax.lax.fori_loop(
        0, nseg, segment,
        (x0, jnp.zeros((BLOCK_LANES,), jnp.int32), jnp.bool_(True)),
    )
    ok = ((x == RANS_L) & seg_ok) | (lens == 0)
    plgpu.store(ok_ref.at[m, lane], ok.astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=("chunk_len", "prob_bits", "ctx_mode", "interpret"),
)
def encode(
    syms: jax.Array,  # [nblocks, K, 1024] byte symbols, or nibbles (ctx)
    lens: jax.Array,  # [nblocks, 1024] i32 lane lengths
    fc: jax.Array,  # [NIDX] u32 packed (f-1) | cum << prob_bits
    chunk_len: int,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
    interpret: bool = False,
):
    """Returns (states u32 [nblocks, 1024], words u16 [ngroups, words_len],
    counts i32 [ngroups]); ngroups = nblocks * num_segments(K), block-major.
    Group g's words are ``words[g, :counts[g]]``."""
    nblocks = syms.shape[0]
    ngroups = nblocks * num_segments(chunk_len)
    kernel = functools.partial(
        _encode_kernel, chunk_len=chunk_len, prob_bits=prob_bits,
        ctx_mode=ctx_mode,
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=(nblocks,),
        in_specs=[any_spec] * 3,
        out_specs=(any_spec,) * 3,
        out_shape=(
            jax.ShapeDtypeStruct((nblocks, BLOCK_LANES), jnp.uint32),
            jax.ShapeDtypeStruct((ngroups, words_len(chunk_len)), jnp.uint16),
            jax.ShapeDtypeStruct((ngroups,), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="rans_encode",
    )(
        syms.reshape(nblocks, chunk_len, BLOCK_LANES),
        lens.reshape(nblocks, BLOCK_LANES).astype(jnp.int32),
        fc.reshape(-1).astype(jnp.uint32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("chunk_len", "prob_bits", "ctx_mode", "interpret"),
)
def decode(
    counts: jax.Array,  # [ngroups] i32 words per (block, segment)
    starts: jax.Array,  # [ngroups] i32 payload index of each group's words
    payload: jax.Array,  # [P] u16
    states: jax.Array,  # [nblocks, 1024] u32
    lens: jax.Array,  # [nblocks, 1024] i32
    table: jax.Array,  # [scale * nctx] u32 fused entries (fused_table)
    chunk_len: int,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
    interpret: bool = False,
):
    """Returns (symbols u8 [nblocks, K, 1024], ok i32 [nblocks, 1024]).

    ``ok`` is 0 on lanes whose final state or segment word count does not
    check out (corrupt stream); word reads outside the payload are masked
    rather than faulting."""
    nblocks = states.shape[0]
    kernel = functools.partial(
        _decode_kernel, chunk_len=chunk_len, prob_bits=prob_bits,
        ctx_mode=ctx_mode, interpret=interpret,
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=(nblocks,),
        in_specs=[any_spec] * 6,
        out_specs=(any_spec,) * 2,
        out_shape=(
            jax.ShapeDtypeStruct((nblocks, chunk_len, BLOCK_LANES), jnp.uint8),
            jax.ShapeDtypeStruct((nblocks, BLOCK_LANES), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="rans_decode",
    )(
        counts.reshape(-1).astype(jnp.int32),
        starts.reshape(-1).astype(jnp.int32),
        payload.reshape(-1),
        states.reshape(nblocks, BLOCK_LANES).astype(jnp.uint32),
        lens.reshape(nblocks, BLOCK_LANES).astype(jnp.int32),
        table.reshape(-1).astype(jnp.uint32),
    )


# ---------------------------------------------------------------------------
# host-side tables


def encode_table(freq: np.ndarray) -> np.ndarray:
    """Order-0 encode table [256] u32: (f-1) | cum << PROB_BITS."""
    freq = np.asarray(freq, dtype=np.uint32)
    cum = np.zeros(256, dtype=np.uint32)
    cum[1:] = np.cumsum(freq)[:-1]
    return ((np.maximum(freq, 1) - 1) & (PROB_SCALE - 1)) | (cum << PROB_BITS)


def ctx_encode_table(freq_ctx: np.ndarray) -> np.ndarray:
    """Context-mode encode table [NCTX*16] u32: (f-1) | cum_within << 7."""
    from fpv_tpu.ops.rans_numpy import ctx_tables

    freq32, cum, _sym_of_slot = ctx_tables(freq_ctx)
    return (
        ((np.maximum(freq32, 1) - 1) & (CTX_PROB_SCALE - 1))
        | (cum << CTX_PROB_BITS)
    ).astype(np.uint32)


def fused_table(freq: np.ndarray) -> np.ndarray:
    """Order-0 decode table, one u32 per slot [PROB_SCALE]:
    ``off << 20 | (f-1) << 8 | sym`` with off = slot - cum[sym]."""
    freq = np.asarray(freq, dtype=np.uint32)
    assert freq.sum() == PROB_SCALE, freq.sum()
    cum = np.zeros(256, dtype=np.uint32)
    cum[1:] = np.cumsum(freq)[:-1]
    sym = np.repeat(np.arange(256, dtype=np.uint32), freq.astype(np.int64))
    off = np.arange(PROB_SCALE, dtype=np.uint32) - cum[sym]
    return (
        (off << np.uint32(8 + PROB_BITS))
        | ((freq[sym] - 1) << np.uint32(8))
        | sym
    )


def ctx_fused_table(freq_ctx: np.ndarray) -> np.ndarray:
    """Context-mode decode table, one u32 per (ctx, slot) [NCTX*128]:
    ``off << 11 | (f-1) << 4 | sym`` (nibble sym, 7-bit f-1 and off)."""
    from fpv_tpu.ops.rans_numpy import ctx_tables

    freq32, cum, sym_of_slot = ctx_tables(freq_ctx)
    idx = np.arange(len(sym_of_slot), dtype=np.uint32)
    sym = sym_of_slot.astype(np.uint32)
    pair = (idx >> CTX_PROB_BITS) * CTX_ALPHA + sym
    off = (idx & (CTX_PROB_SCALE - 1)) - cum[pair].astype(np.uint32)
    return (
        (off << np.uint32(4 + CTX_PROB_BITS))
        | ((freq32[pair].astype(np.uint32) - 1) << np.uint32(4))
        | sym
    )
