"""Vectorized numpy rANS engine (oracle + CPU fallback).

Implements exactly the stream layout of fpv_tpu.ops.rans_layout.  Vectorized
across all lanes per symbol step, so it is fast enough to serve as the CPU
fallback while doubling as the bit-level oracle the GPU kernels
(fpv_tpu.ops.rans_triton) are tested against.
"""

from __future__ import annotations

import numpy as np

from fpv_tpu.ops.rans_layout import (
    BLOCK_LANES,
    CTX_ALPHA,
    CTX_NCTX,
    CTX_PROB_BITS,
    CTX_PROB_SCALE,
    PROB_BITS,
    PROB_SCALE,
    RANS_L,
    SEG_LEN,
    num_segments,
)


def ctx_from_prev(
    prev: np.ndarray, nblocks: int, lanes: int = BLOCK_LANES
) -> np.ndarray:
    """Context ids from the previous step's (masked) symbols.

    ``prev`` is [C_pad] int32 with zeros at step 0 / beyond lane lengths;
    neighbors wrap within each block's ``lanes`` lanes (see rans_layout docs).
    """
    p = prev.reshape(nblocks, lanes)
    al = np.roll(p, 1, axis=1)
    ar = np.roll(p, -1, axis=1)
    return (p * 2 + (al != ar)).reshape(-1).astype(np.int32)


def encode_ctx_indices(
    sym4: np.ndarray, lens: np.ndarray, lanes: int = BLOCK_LANES
) -> np.ndarray:
    """[C_pad, K] nibble symbols (zero-padded) -> fc indices ctx*16+sym."""
    c_pad, k = sym4.shape
    nblocks = c_pad // lanes
    lens = np.asarray(lens, dtype=np.int32)
    idx = np.zeros((c_pad, k), np.int32)
    prev = np.zeros(c_pad, np.int32)
    for j in range(k):
        ctx = ctx_from_prev(prev, nblocks, lanes)
        idx[:, j] = ctx * CTX_ALPHA + sym4[:, j]
        prev = np.where(j < lens, sym4[:, j].astype(np.int32), 0)
    return idx


def ctx_tables(freq_ctx: np.ndarray):
    """[NCTX*ALPHA] per-context freqs (each ctx sums to CTX_PROB_SCALE) ->
    (freq32 flat, cum-within-ctx flat, sym_of_slot [NCTX*128])."""
    freq_ctx = np.asarray(freq_ctx, dtype=np.uint32).reshape(
        CTX_NCTX, CTX_ALPHA
    )
    cum = np.zeros_like(freq_ctx)
    cum[:, 1:] = np.cumsum(freq_ctx, axis=1)[:, :-1]
    sym_of_slot = np.concatenate(
        [
            np.repeat(np.arange(CTX_ALPHA, dtype=np.int32), freq_ctx[c])
            for c in range(CTX_NCTX)
        ]
    )
    return freq_ctx.reshape(-1), cum.reshape(-1), sym_of_slot


def encode_blocks(
    symbols: np.ndarray,  # [C_pad, K] fc indices (zero beyond lens)
    lens: np.ndarray,  # [C_pad] int32
    freq: np.ndarray,  # [NIDX] frequencies
    prob_bits: int = PROB_BITS,
    cum: np.ndarray | None = None,  # [NIDX]; default: global excl. cumsum
    lanes: int = BLOCK_LANES,
):
    """Returns (states u32 [C_pad], block_counts u32 [nblocks], payload u16)."""
    c_pad, k = symbols.shape
    assert c_pad % lanes == 0
    nblocks = c_pad // lanes
    renorm_shift = 31 - prob_bits
    freq32 = np.maximum(np.asarray(freq).astype(np.uint32), 1)
    if cum is None:
        cum = np.zeros(len(freq32), dtype=np.uint32)
        cum[1:] = np.cumsum(np.asarray(freq).astype(np.uint32))[:-1]
    else:
        cum = np.asarray(cum, dtype=np.uint32)

    x = np.full(c_pad, RANS_L, dtype=np.uint32)
    words = np.zeros((k, c_pad), dtype=np.uint16)  # by symbol index j
    emits = np.zeros((k, c_pad), dtype=bool)
    lens = np.asarray(lens, dtype=np.int32)
    syms = symbols.astype(np.int32)

    for t in range(k):
        j = k - 1 - t
        active = j < lens
        s = syms[:, j]
        f = np.where(active, freq32[s], 1).astype(np.uint32)
        c = cum[s]
        emit = active & (x >= (f << renorm_shift))
        words[j, emit] = (x[emit] & 0xFFFF).astype(np.uint16)
        emits[j] = emit
        x2 = np.where(emit, x >> 16, x)
        q = x2 // f
        xn = (q << prob_bits) + (x2 - q * f) + np.where(active, c, 0)
        x = np.where(active, xn, x)

    # payload: per block, segments ASCENDING; within a segment, groups in
    # DESCENDING j order, row-major lanes; one count per (block, segment)
    nseg = num_segments(k)
    counts = np.zeros((nblocks, nseg), dtype=np.uint32)
    parts = []
    for m in range(nblocks):
        sl = slice(m * lanes, (m + 1) * lanes)
        for g in range(nseg):
            jlo, jhi = g * SEG_LEN, min((g + 1) * SEG_LEN, k)
            w = words[jhi - 1 : jlo - 1 if jlo else None : -1, sl]
            e = emits[jhi - 1 : jlo - 1 if jlo else None : -1, sl]
            parts.append(w[e])  # row-major: j-major, lane-minor
            counts[m, g] = int(e.sum())
    payload = np.concatenate(parts) if parts else np.zeros(0, np.uint16)
    return x, counts.reshape(-1), payload


def decode_blocks(
    states: np.ndarray,  # [C_pad] uint32
    block_counts: np.ndarray,  # [nblocks] uint32
    payload: np.ndarray,  # [sum(counts)] uint16
    lens: np.ndarray,  # [C_pad] int32
    freq: np.ndarray,  # [256] uint16
    chunk_len: int,
    lanes: int = BLOCK_LANES,
):
    """Returns (symbols u8 [C_pad, K], ok bool [C_pad])."""
    c_pad = len(states)
    nblocks = c_pad // lanes
    k = chunk_len
    nseg = num_segments(k)
    cum = np.zeros(256, dtype=np.uint32)
    cum[1:] = np.cumsum(freq.astype(np.uint32))[:-1]
    sym_of_slot = np.repeat(
        np.arange(256, dtype=np.int32), freq.astype(np.int64)
    )
    freq32 = freq.astype(np.uint32)

    counts2 = block_counts.astype(np.int64).reshape(nblocks, nseg)
    group_base = np.zeros(nblocks * nseg, dtype=np.int64)
    group_base[1:] = np.cumsum(counts2.reshape(-1))[:-1]
    group_base = group_base.reshape(nblocks, nseg)
    # decoder consumes each (block, segment) region backward from its end
    ptr = counts2[:, 0].copy()
    gb = group_base[:, 0]
    seg_ok = np.ones(nblocks, dtype=bool)

    x = states.astype(np.uint32).copy()
    lens = np.asarray(lens, dtype=np.int32)
    out = np.zeros((c_pad, k), dtype=np.uint8)
    lane_block = np.arange(c_pad) // lanes

    for j in range(k):
        if j and j % SEG_LEN == 0:
            g = j // SEG_LEN
            seg_ok &= ptr == 0
            ptr = counts2[:, g].copy()
            gb = group_base[:, g]
        active = j < lens
        slot = (x & (PROB_SCALE - 1)).astype(np.int64)
        s = sym_of_slot[slot]
        f = freq32[s]
        xn = f * (x >> PROB_BITS) + (slot.astype(np.uint32) - cum[s])
        renorm = active & (xn < RANS_L)
        # group ranks: row-major within block
        r2 = renorm.reshape(nblocks, lanes)
        ranks = np.cumsum(r2, axis=1) - 1
        cnts = r2.sum(axis=1)
        base = gb[lane_block] + (ptr[lane_block] - cnts[lane_block])
        pos = base + ranks.reshape(-1)
        w = np.zeros(c_pad, dtype=np.uint32)
        if renorm.any():
            # clip instead of raising on corrupt input; the final state/ptr
            # integrity check reports the corruption
            safe = np.clip(pos[renorm], 0, max(len(payload) - 1, 0))
            if len(payload):
                w[renorm] = payload[safe].astype(np.uint32)
        xn2 = np.where(renorm, (xn << 16) | w, xn)
        x = np.where(active, xn2, x)
        ptr -= cnts
        out[active, j] = s[active].astype(np.uint8)

    seg_ok &= ptr == 0
    ok = (x == RANS_L) & seg_ok[lane_block] | (lens == 0)
    # lanes with len 0 never touched: state stays as given (RANS_L expected)
    return out, ok


def decode_blocks_ctx(
    states: np.ndarray,  # [C_pad] uint32
    block_counts: np.ndarray,  # [nblocks] uint32
    payload: np.ndarray,  # [sum(counts)] uint16
    lens: np.ndarray,  # [C_pad] int32
    freq_ctx: np.ndarray,  # [NCTX*ALPHA] per-context frequencies
    chunk_len: int,
    lanes: int = BLOCK_LANES,
):
    """Context-mode decode (coding=1): (nibble symbols u8 [C_pad, K], ok)."""
    c_pad = len(states)
    nblocks = c_pad // lanes
    k = chunk_len
    nseg = num_segments(k)
    freq32, cum, sym_of_slot = ctx_tables(freq_ctx)
    freq32 = np.maximum(freq32, 1)

    counts2 = block_counts.astype(np.int64).reshape(nblocks, nseg)
    group_base = np.zeros(nblocks * nseg, dtype=np.int64)
    group_base[1:] = np.cumsum(counts2.reshape(-1))[:-1]
    group_base = group_base.reshape(nblocks, nseg)
    ptr = counts2[:, 0].copy()
    gb = group_base[:, 0]
    seg_ok = np.ones(nblocks, dtype=bool)

    x = states.astype(np.uint32).copy()
    lens = np.asarray(lens, dtype=np.int32)
    out = np.zeros((c_pad, k), dtype=np.uint8)
    lane_block = np.arange(c_pad) // lanes
    prev = np.zeros(c_pad, np.int32)

    for j in range(k):
        if j and j % SEG_LEN == 0:
            g = j // SEG_LEN
            seg_ok &= ptr == 0
            ptr = counts2[:, g].copy()
            gb = group_base[:, g]
        active = j < lens
        ctx = ctx_from_prev(prev, nblocks, lanes)
        slot = (x & (CTX_PROB_SCALE - 1)).astype(np.int64)
        s = sym_of_slot[ctx * CTX_PROB_SCALE + slot]
        idx = ctx * CTX_ALPHA + s
        f = freq32[idx]
        xn = f * (x >> CTX_PROB_BITS) + (slot.astype(np.uint32) - cum[idx])
        renorm = active & (xn < RANS_L)
        r2 = renorm.reshape(nblocks, lanes)
        ranks = np.cumsum(r2, axis=1) - 1
        cnts = r2.sum(axis=1)
        base = gb[lane_block] + (ptr[lane_block] - cnts[lane_block])
        pos = base + ranks.reshape(-1)
        w = np.zeros(c_pad, dtype=np.uint32)
        if renorm.any() and len(payload):
            safe = np.clip(pos[renorm], 0, max(len(payload) - 1, 0))
            w[renorm] = payload[safe].astype(np.uint32)
        xn2 = np.where(renorm, (xn << 16) | w, xn)
        x = np.where(active, xn2, x)
        ptr -= cnts
        out[active, j] = s[active].astype(np.uint8)
        prev = np.where(active, s.astype(np.int32), 0)

    seg_ok &= ptr == 0
    ok = (x == RANS_L) & seg_ok[lane_block] | (lens == 0)
    return out, ok
