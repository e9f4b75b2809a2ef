"""Batched prediction ops on device.

Encode-side transforms are embarrassingly parallel (they read original
neighbor values, like the reference's reverse-order loop into a fresh buffer,
fusion_power_video.cc:564-572) and compile to fused elementwise programs.

Decode-side:

* delta: elementwise add.
* reference ("flat") CG: the reference treats the plane as a FLAT buffer, so
  a column-0 pixel's west neighbor is the previous row's last pixel
  (``high[i-1]`` at ``i = y*W``, fusion_power_video.cc:326-333).  That wrap
  gives the reconstruction an O(H*W) critical path — inherently sequential —
  so compat decode runs on host (numpy/native); see
  :func:`fpv_tpu.models.predictors.cg_decode_np`.
* FPVT 2D CG: the FPVT profile defines CG without the wrap (row 0
  verbatim, column 0 north-predicted), decodable by an anti-diagonal
  wavefront with O(H+W) depth — :func:`cg2d_decode`.
* FPVT "up" predictor: pure north prediction; decode is a mod-256 cumulative
  sum down columns, O(log H) depth.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fpv_tpu import backend


def clamped_gradient(n: jax.Array, w: jax.Array, nw: jax.Array) -> jax.Array:
    """Branchless ClampedGradient on uint8 (fusion_power_video.cc:247-252)."""
    i = jnp.minimum(n, w)
    a = jnp.maximum(n, w)
    g = n + w - nw  # uint8 wraparound
    clamped = jnp.where(nw < i, a, g)
    return jnp.where(nw > a, i, clamped)


@jax.jit
def delta_encode(plane: jax.Array, delta_plane: jax.Array) -> jax.Array:
    return plane - delta_plane  # uint8 wrap


@jax.jit
def delta_decode(plane: jax.Array, delta_plane: jax.Array) -> jax.Array:
    return plane + delta_plane  # uint8 wrap


@jax.jit
def cg_flat_encode(plane: jax.Array) -> jax.Array:
    """Reference-semantics CG residual of [B, H, W] uint8 planes.

    Flat-buffer neighbors: n = flat[i-W], w = flat[i-1], nw = flat[i-W-1];
    pixels i <= W (row 0 plus (1,0)) are stored verbatim
    (fusion_power_video.cc:564-572).
    """
    b, h, w = plane.shape
    flat = plane.reshape(b, h * w)
    n = jnp.roll(flat, w, axis=1)
    ww = jnp.roll(flat, 1, axis=1)
    nw = jnp.roll(flat, w + 1, axis=1)
    res = flat - clamped_gradient(n, ww, nw)
    idx = jnp.arange(h * w)
    out = jnp.where(idx >= w + 1, res, flat)
    return out.reshape(b, h, w)


@jax.jit
def cg2d_encode(plane: jax.Array) -> jax.Array:
    """FPVT 2D CG residual: row 0 verbatim, column 0 north-predicted,
    interior clamped-gradient.  Fully parallel."""
    n = jnp.roll(plane, 1, axis=1)
    w = jnp.roll(plane, 1, axis=2)
    nw = jnp.roll(n, 1, axis=2)
    pred = clamped_gradient(n, w, nw)
    res = plane - pred
    res_col0 = plane - n  # north-only on column 0
    b, h, wd = plane.shape
    cols = jnp.arange(wd)[None, None, :]
    rows = jnp.arange(h)[None, :, None]
    out = jnp.where(cols == 0, res_col0, res)
    return jnp.where(rows == 0, plane, out)


def _cg2d_kernel(res_ref, out_ref, *, h: int, w: int, hp: int,
                 interpret: bool):
    """One frame: walk the H+W-1 anti-diagonals, one lane per row.

    Lane y reconstructs (y, d-y) on diagonal d.  Its west neighbour is the
    value it made on the previous diagonal and its north-west neighbour is
    the north value it read there, so both stay in registers; only the
    north neighbour, made by lane y-1 one diagonal earlier, comes back
    through memory, behind a block barrier."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    b = pl.program_id(0)
    y = jnp.arange(hp, dtype=jnp.int32)
    yc = jnp.minimum(y, h - 1)
    ym = jnp.maximum(y - 1, 0)

    def step(d, carry):
        west, northwest = carry
        x = d - y
        valid = (y < h) & (x >= 0) & (x < w)
        xc = jnp.clip(x, 0, w - 1)
        cur = plgpu.load(res_ref.at[b, yc, xc], mask=valid, other=0)
        north = plgpu.load(
            out_ref.at[b, ym, xc], mask=valid & (y > 0), other=0
        ).astype(jnp.int32)
        lo = jnp.minimum(north, west)
        hi = jnp.maximum(north, west)
        grad = (north + west - northwest) & 0xFF
        cg = jnp.where(northwest > hi, lo,
                       jnp.where(northwest < lo, hi, grad))
        pred = jnp.where(y == 0, 0, jnp.where(x == 0, north, cg))
        new = (cur.astype(jnp.int32) + pred) & 0xFF
        plgpu.store(out_ref.at[b, y, xc], new.astype(jnp.uint8), mask=valid)
        if not interpret:
            plgpu.debug_barrier()
        return new, north

    zero = jnp.zeros((hp,), jnp.int32)
    jax.lax.fori_loop(0, h + w - 1, step, (zero, zero))


@functools.partial(jax.jit, static_argnames=("interpret",))
def _cg2d_decode_kernel(res: jax.Array, interpret: bool = False):
    """Wavefront reconstruction of :func:`cg2d_encode` ([B,H,W] u8), one
    GPU program per frame (Pallas through Triton).  Rows are padded to a
    power of two (Triton block sizes) and the padding lanes write rows of
    their own, cropped at the end."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    b, h, w = res.shape
    hp = 1 << max(h - 1, 1).bit_length()
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        functools.partial(_cg2d_kernel, h=h, w=w, hp=hp, interpret=interpret),
        grid=(b,),
        in_specs=[any_spec],
        out_specs=any_spec,
        out_shape=jax.ShapeDtypeStruct((b, hp, w), jnp.uint8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(4, min(16, hp // 256))
        ),
        interpret=interpret,
        name="cg2d_decode",
    )(res)
    return out[:, :h]


def cg2d_decode(res: jax.Array) -> jax.Array:
    """Wavefront CG2D reconstruction of a [B,H,W] u8 residual batch: the
    GPU kernel, or the numpy wavefront under the host engine
    (fpv_tpu.backend decides)."""
    if backend.engine() == "numpy":
        from fpv_tpu.models.predictors import cg2d_decode_np

        return jax.pure_callback(
            cg2d_decode_np, jax.ShapeDtypeStruct(res.shape, jnp.uint8), res,
            vmap_method="sequential",
        )
    return _cg2d_decode_kernel(res, interpret=backend.interpret())


@jax.jit
def up_encode(plane: jax.Array) -> jax.Array:
    """North-prediction residual: row 0 verbatim, rows y: x[y]-x[y-1] mod 256."""
    n = jnp.roll(plane, 1, axis=1)
    res = plane - n
    rows = jnp.arange(plane.shape[1])[None, :, None]
    return jnp.where(rows == 0, plane, res)


@jax.jit
def up_decode(res: jax.Array) -> jax.Array:
    """Inverse of :func:`up_encode`: mod-256 cumulative sum down columns.

    uint8 addition is associative mod 256, so XLA's parallel prefix-sum
    applies — O(log H) depth, no sequential scan.
    """
    return jnp.cumsum(res, axis=1, dtype=jnp.uint8).astype(jnp.uint8)
