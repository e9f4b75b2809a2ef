"""Shared layout math for the block-interleaved rANS stream.

Coder (see docs/FORMAT_FPVT.md): 12-bit probabilities, 31-bit state in
[2^15, 2^31), 16-bit renormalization, initial/final state 2^15.

Stream layout ("step-major descending"):

* a plane batch of B frames is cut into chunks of K symbols (ceil(S/K) per
  frame, last chunk short); the chunk array is padded to a multiple of
  BLOCK_LANES = 1024 lanes (pad lanes have length 0);
* lanes are grouped into blocks of 1024;
* chunks longer than SEG_LEN = 512 are cut into ceil(K / SEG_LEN) segments,
  each with its own word region and count (rANS state carries across
  segments, so only one u32 state per chunk is ever stored — long chunks
  amortize the ~16 wasted bits each state costs);
* each block's payload is the concatenation of its segments in ASCENDING
  segment order; within a segment, per-symbol-step word groups in
  DESCENDING symbol order (the encoder's natural emission order — it codes
  symbols in reverse, segments last-to-first); within a group, words are
  in row-major lane order; the DECODER consumes each segment's region
  backward from that segment's word count;
* per chunk: a u32 final state; per (block, segment): a u32 word count,
  block-major.

This gives both sides fully static shapes, lets the encoder write forward
with a scalar pointer, and lets the decoder expand each group with one
window read — no per-lane stream cursors.
"""

from __future__ import annotations

import numpy as np

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 15
RENORM_SHIFT = 19  # emit while x >= freq << 19 ((L >> PROB_BITS) * 2^16)

BLOCK_LANES = 1024

# Segment length along the symbol-step axis.  A format-level constant —
# the payload's (block, segment) grouping depends on it.  chunk_len <= SEG_LEN streams are laid out exactly as before
# segments existed (one segment).
SEG_LEN = 512


def num_segments(chunk_len: int) -> int:
    return max(1, -(-chunk_len // SEG_LEN))

# Context-coded low-plane mode (plane-stream coding=1): when the container
# shift is >= 4 the low plane's bottom nibble is structurally zero, so the
# alphabet is 16 symbols (sym = low >> 4).  Symbols code against per-context
# conditional tables; the context is computed from already-decoded in-lane
# history (the symbol 1024 flat positions back = previous step, plus its
# +-1 lane neighbors, which are the previous step's decoded vector):
#
#     ctx = a * 2 + (al != ar)        in [0, 32)
#
# where a/al/ar are the previous step's symbols at lanes l, l-1, l+1
# (wrapping within the block's 1024 lanes; zeros at step 0 and beyond each
# lane's length, matching the encoder's zero padding).  Tables use 7-bit
# probabilities so the decode slot table (NCTX * 128 slots = 4096) stays the
# same [8,128] packed shape as the order-0 mode's.
CTX_ALPHA = 16
CTX_NCTX = 32
CTX_NIDX = CTX_NCTX * CTX_ALPHA  # 512 (ctx, sym) pairs
CTX_PROB_BITS = 7
CTX_PROB_SCALE = 1 << CTX_PROB_BITS
CTX_RENORM_SHIFT = 31 - CTX_PROB_BITS  # 24

CODING_ORDER0 = 0
CODING_CTX16 = 1
# constant plane batch: the stream stores only the byte value — no tables,
# no states, no counts, no payload.  The short-circuit that captures the
# LZ77 role brotli-q1 plays on exact-repetition content
# (/root/reference/fusion_power_video.cc:166-169): after delta prediction a
# repeated frame's residual planes are all-zero and cost ~nothing.
CODING_CONST = 2
# stored (raw) plane batch: the stream is the residual plane bytes verbatim
# — no tables, no states, no counts.  Chosen by encoders exactly when the
# rANS stream would not be smaller (incompressible planes: 16-bit noise
# codes at ~8.005 bits/byte plus table/state overhead), so the worst case
# is bounded at 1 byte/byte + 24 bytes/stream and decodes at memcpy speed
# instead of paying two rANS kernel passes.  The role of deflate's stored
# blocks; the reference has no equivalent (brotli-q1 on noise emits
# slightly MORE than raw, fusion_power_video.cc:166-169).
CODING_RAW = 3

# Narrow streams: small plane batches (delta sections, small-file batches)
# may use fewer than 1024 lanes per block so they store proportionally fewer
# chunk states (each stored u32 state costs ~24 structural bits over the
# content it carries — on a one-frame delta section 1024 lanes would be
# ~1.5% of the stream).  Lane count is a per-stream field; the layout rules
# below are identical with ``lanes`` substituted for 1024.  Narrow streams
# trade device-kernel parallelism for size, so encoders only choose them
# when the plane batch is small (see plane_codec narrow policy); they are
# coded by the host engine.
LANES_MIN = 8


def chunk_lens(
    nframes: int, plane_size: int, chunk_len: int, lanes: int = BLOCK_LANES
) -> np.ndarray:
    """Per-chunk (lane) symbol counts for the interleaved layout.

    The plane batch is one flat symbol stream of N = nframes*plane_size
    bytes.  Block m covers the contiguous region [m*K*lanes, (m+1)*K*lanes);
    within a block, lane l codes symbols {base + j*lanes + l}.  This makes
    the [K, lanes] step-major array a pure reshape of the flat stream (no
    device transposes) while keeping blocks contiguous for random access.
    Lane lengths within the last block differ by at most one.
    """
    n = nframes * plane_size
    span = chunk_len * lanes
    nb = max(1, -(-n // span))
    lane_idx = np.arange(lanes, dtype=np.int64)
    out = np.empty((nb, lanes), dtype=np.int32)
    for m in range(nb):
        r = min(max(n - m * span, 0), span)
        out[m] = np.minimum((r - lane_idx + lanes - 1) // lanes,
                            chunk_len).clip(0)
    return out.reshape(-1).astype(np.int32)


def num_chunks(
    nframes: int, plane_size: int, chunk_len: int, lanes: int = BLOCK_LANES
) -> int:
    return num_blocks(nframes, plane_size, chunk_len, lanes) * lanes


def num_blocks(
    nframes: int, plane_size: int, chunk_len: int, lanes: int = BLOCK_LANES
) -> int:
    n = nframes * plane_size
    span = chunk_len * lanes
    return max(1, -(-n // span))
