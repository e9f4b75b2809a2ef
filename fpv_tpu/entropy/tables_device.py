"""On-device rANS table construction (for fully-fused encode programs).

The fused encode jit cannot round-trip histograms to the host, so frequency
normalization runs on device.  The resulting table is written into the
container verbatim, so host/device normalizers never need to agree — any
valid table (sum == 4096, all symbols >= 1) decodes correctly.

Scheme: ``freq = 1 + largest_remainder(hist, PROB_SCALE - 256)`` — every
symbol gets a floor of 1 (guaranteeing sampled-histogram encodability) and
the remaining 3840 units are apportioned proportionally with deterministic
largest-remainder rounding (ties by symbol index).  f32 rounding slack is
absorbed by allowing up to two +1 rounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fpv_tpu.entropy.tables import PROB_BITS, PROB_SCALE


def normalize_freqs_device(
    hist: jax.Array, mask: jax.Array | None = None
) -> jax.Array:
    """[256] int histogram -> [256] u32 freq table (sum PROB_SCALE).

    ``mask`` ([256] 0/1, optional) is an exact-support superset: symbols
    outside it get frequency 0 (they provably never occur, so the floor
    of 1 that guards against sampled-histogram misses is wasted code space
    on them — ~0.09 bits/symbol on narrow-support residual planes).
    Without a mask every symbol gets the floor (legacy behavior).
    """
    h = hist.astype(jnp.float32)
    if mask is None:
        maskf = jnp.ones(256, jnp.float32)
        nfloor = jnp.float32(256.0)
    else:
        maskf = mask.astype(jnp.float32)
        nfloor = jnp.sum(maskf)
    h = h * maskf  # sampled counts are within the mask; belt and braces
    total = jnp.maximum(jnp.sum(h), 1.0)
    scale = jnp.float32(PROB_SCALE) - nfloor
    ideal = h * (scale / total)
    # bias down so f32 rounding can't push floor above the exact value
    base = jnp.floor(ideal * (1.0 - 1e-6)).astype(jnp.int32)
    base = jnp.maximum(base, 0)
    rem = ideal - base.astype(jnp.float32)
    d = scale.astype(jnp.int32) - jnp.sum(base)
    # rank symbols by remainder, ties by index (lower index first);
    # out-of-mask symbols rank last so the +1 rounds never reach them
    key = (
        rem * 512.0
        - jnp.arange(256, dtype=jnp.float32) / 256.0
        - (1.0 - maskf) * 1e9
    )
    # rank via double argsort (no scatter)
    rank = jnp.argsort(jnp.argsort(-key)).astype(jnp.int32)
    # second +1 round wraps after nfloor (the number of masked symbols), not
    # 256 — with a small mask a 256 threshold would land rounds on
    # out-of-mask symbols (zeroed by maskf, dumping slack on the argmax bin)
    extra = (rank < d).astype(jnp.int32) + (
        rank < d - nfloor.astype(jnp.int32)
    ).astype(jnp.int32)
    freq = (1 + base + extra) * maskf.astype(jnp.int32)
    # exact-sum safety net: absorb any residual rounding slack into the
    # largest bin (always big enough to take a few +/-1 units)
    resid = PROB_SCALE - jnp.sum(freq)
    amax = jnp.argmax(freq)
    freq = freq.at[amax].add(resid)
    return freq.astype(jnp.uint32)


def normalize_freqs_ctx_device(
    hist: jax.Array, mask: jax.Array | None = None
) -> jax.Array:
    """[NCTX*ALPHA] joint histogram -> per-context tables on device.

    Vectorized largest-remainder apportionment per context row.  Without
    ``mask`` every symbol gets a floor of 1 (sampled-histogram safety);
    with a mask (exact (ctx, sym) support superset, 0/1) only masked pairs
    are floored and absent pairs get frequency 0 — see normalize_freqs_ctx.
    A context with an all-zero mask row gets a uniform table (nothing is
    ever coded against it)."""
    from fpv_tpu.ops.rans_layout import CTX_ALPHA, CTX_NCTX, CTX_PROB_SCALE

    h = hist.astype(jnp.float32).reshape(CTX_NCTX, CTX_ALPHA)
    if mask is None:
        maskf = jnp.ones((CTX_NCTX, CTX_ALPHA), jnp.float32)
    else:
        maskf = mask.astype(jnp.float32).reshape(CTX_NCTX, CTX_ALPHA)
    nfloor = jnp.sum(maskf, axis=1, keepdims=True)
    empty_row = nfloor < 0.5  # context never occurs
    h = h * maskf
    total = jnp.maximum(jnp.sum(h, axis=1, keepdims=True), 1.0)
    scale = jnp.float32(CTX_PROB_SCALE) - nfloor
    ideal = h * (scale / total)
    base = jnp.maximum(jnp.floor(ideal * (1.0 - 1e-6)).astype(jnp.int32), 0)
    rem = ideal - base.astype(jnp.float32)
    d = scale.astype(jnp.int32) - jnp.sum(base, axis=1, keepdims=True)
    key = (
        rem * 512.0
        - jnp.arange(CTX_ALPHA, dtype=jnp.float32) / 256.0
        - (1.0 - maskf) * 1e9
    )
    rank = jnp.argsort(jnp.argsort(-key, axis=1), axis=1).astype(jnp.int32)
    # per-row masked-symbol count bounds the second +1 round (see the
    # order-0 normalizer above)
    extra = (rank < d).astype(jnp.int32) + (
        rank < d - nfloor.astype(jnp.int32)
    ).astype(jnp.int32)
    freq = (1 + base + extra) * maskf.astype(jnp.int32)
    uniform = jnp.full(
        (CTX_NCTX, CTX_ALPHA), CTX_PROB_SCALE // CTX_ALPHA, jnp.int32
    )
    freq = jnp.where(empty_row, uniform, freq)
    resid = CTX_PROB_SCALE - jnp.sum(freq, axis=1, keepdims=True)
    amax = jnp.argmax(freq, axis=1)
    onehot = (
        jnp.arange(CTX_ALPHA, dtype=jnp.int32)[None, :] == amax[:, None]
    ).astype(jnp.int32)
    freq = freq + resid * onehot  # no scatter
    return freq.reshape(-1).astype(jnp.uint32)


def encode_tables_ctx_device(freq: jax.Array) -> jax.Array:
    """[NCTX*ALPHA] u32 ctx tables -> encode table [NCTX*ALPHA] u32:
    (f-1) | cum_within << 7."""
    from fpv_tpu.ops.rans_layout import CTX_ALPHA, CTX_NCTX, CTX_PROB_BITS

    f = freq.reshape(CTX_NCTX, CTX_ALPHA)
    cum = jnp.concatenate(
        [
            jnp.zeros((CTX_NCTX, 1), jnp.uint32),
            jnp.cumsum(f, axis=1)[:, :-1].astype(jnp.uint32),
        ],
        axis=1,
    )
    fc = ((f - 1) & ((1 << CTX_PROB_BITS) - 1)) | (cum << CTX_PROB_BITS)
    return fc.reshape(-1)


def fused_decode_tables_device(freq: jax.Array) -> jax.Array:
    """freq u32 [256] -> fused decode table [PROB_SCALE] u32.

    Device twin of rans_triton.fused_table: one entry per slot,
    ``off << 20 | (f-1) << 8 | sym``.  Per-slot f and cum are integer
    gathers, exact for every table (entries reach PROB_SCALE)."""
    freq = freq.astype(jnp.int32)
    cum_incl = jnp.cumsum(freq)  # [256]
    slots = jnp.arange(PROB_SCALE, dtype=jnp.int32)
    sym = jnp.searchsorted(cum_incl, slots, side="right").astype(jnp.int32)
    f = freq[sym]
    off = slots - (cum_incl - freq)[sym]
    return (
        (off.astype(jnp.uint32) << 20)
        | ((f - 1).astype(jnp.uint32) << 8)
        | sym.astype(jnp.uint32)
    )


def encode_tables_device(freq: jax.Array) -> jax.Array:
    """freq u32 [256] -> encode table [256] u32: (f-1) | cum << 12."""
    cum = jnp.concatenate(
        [jnp.zeros(1, jnp.uint32), jnp.cumsum(freq)[:-1].astype(jnp.uint32)]
    )
    return ((freq - 1) & 0xFFF) | (cum << PROB_BITS)
