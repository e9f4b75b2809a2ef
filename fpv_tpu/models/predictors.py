"""Prediction models of the codec, as pure functions (numpy oracle versions).

Three predictors exist in the reference (and therefore here):

* byte-plane **delta** prediction against one static delta frame
  (fusion_power_video.cc:517-544) — per-plane subtraction mod 256;
* **clamped-gradient** (CG) spatial prediction of the high plane
  (fusion_power_video.cc:546-593) — residual against
  ``clamp(n + w - nw, min(n, w), max(n, w))`` of the already-decoded
  north/west/northwest neighbors;
* the implicit **null** predictor (store plane verbatim).

These numpy versions define the exact semantics; the batched JAX/Pallas
versions in :mod:`fpv_tpu.ops` are verified against them in tests.
"""

from __future__ import annotations

import numpy as np

try:  # native scan kernels (see native/fpv_native.cc); optional
    import fpv_native as _native
except ImportError:  # pragma: no cover
    _native = None


def clamped_gradient_np(n, w, nw):
    """Branchless clamped-gradient predictor on uint8 arrays.

    Exact port of ``ClampedGradient`` (fusion_power_video.cc:247-252):
    ``i = min(n,w); a = max(n,w); g = uint8(n + w - nw);
    return nw > a ? i : (nw < i ? a : g)``.
    """
    n = np.asarray(n, dtype=np.uint8)
    w = np.asarray(w, dtype=np.uint8)
    nw = np.asarray(nw, dtype=np.uint8)
    i = np.minimum(n, w)
    a = np.maximum(n, w)
    g = (n + w - nw).astype(np.uint8)  # uint8 wraparound
    clamped = np.where(nw < i, a, g)
    return np.where(nw > a, i, clamped).astype(np.uint8)


def delta_encode_np(plane: np.ndarray, delta_plane: np.ndarray) -> np.ndarray:
    """plane - delta_plane mod 256 (fusion_power_video.cc:534-537)."""
    return (plane.astype(np.uint8) - delta_plane.astype(np.uint8)).astype(np.uint8)


def delta_decode_np(plane: np.ndarray, delta_plane: np.ndarray) -> np.ndarray:
    """plane + delta_plane mod 256 (fusion_power_video.cc:600-603)."""
    return (plane.astype(np.uint8) + delta_plane.astype(np.uint8)).astype(np.uint8)


def cg_encode_np(plane: np.ndarray) -> np.ndarray:
    """CG residual of a [H, W] uint8 plane.

    The reference runs its loop in reverse scan order into a fresh buffer so
    every prediction reads *original* neighbor values
    (fusion_power_video.cc:564-572) — i.e. the transform is embarrassingly
    parallel.  Row 0 and the first pixel of row 1 are stored verbatim.
    """
    plane = np.asarray(plane, dtype=np.uint8)
    h, w = plane.shape
    out = plane.copy()
    if h < 2 or w < 1:
        return out
    flat = plane.reshape(-1)
    size = h * w
    xs = w
    idx = np.arange(xs + 1, size)
    pred = clamped_gradient_np(flat[idx - xs], flat[idx - 1], flat[idx - xs - 1])
    res = (flat[idx] - pred).astype(np.uint8)
    out_flat = out.reshape(-1)
    out_flat[xs + 1:] = res
    return out_flat.reshape(h, w)


def cg_decode_np(plane: np.ndarray) -> np.ndarray:
    """Inverse CG scan of a [H, W] uint8 residual plane.

    Sequential reconstruction (fusion_power_video.cc:326-333): each pixel
    needs the already-reconstructed n/w/nw.  This is the numpy oracle; the
    FPVT profile's 2D CG avoids the row wrap (:func:`cg2d_decode_np`).
    """
    plane = np.asarray(plane, dtype=np.uint8)
    h, w = plane.shape
    if h < 2 or w < 1:
        return plane.copy()
    out = plane.reshape(-1).copy()
    xs = w
    size = h * w
    # Row-wise: within a row the W-dependency is sequential, but n/nw come
    # from the completed previous row.  We keep the loop per-pixel in the
    # oracle for clarity/fidelity.
    for i in range(xs + 1, size):
        n = out[i - xs]
        ww = out[i - 1]
        nw = out[i - xs - 1]
        out[i] = (int(out[i]) + int(clamped_gradient_np(n, ww, nw))) & 0xFF
    return out.reshape(h, w)


def cg2d_decode_np(res: np.ndarray) -> np.ndarray:
    """Inverse of the FPVT 2D CG residual (fpv_tpu.ops.predict.cg2d_encode)
    for [B, H, W] uint8 planes: row 0 verbatim, column 0 north-predicted,
    interior clamped-gradient.  Anti-diagonal wavefront: diagonal d needs
    only diagonals d-1 and d-2, so each step is one vectorised update."""
    res = np.asarray(res, dtype=np.uint8)
    b, h, w = res.shape
    # pixel (y, x) lives at out[:, y+1, x+1]; row/column 0 of out are zero
    out = np.zeros((b, h + 1, w + 1), np.uint8)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        n = out[:, y, x + 1]
        pred = clamped_gradient_np(n, out[:, y + 1, x], out[:, y, x])
        pred = np.where(x == 0, n, pred)
        pred = np.where(y == 0, 0, pred).astype(np.uint8)
        out[:, y + 1, x + 1] = res[:, y, x] + pred
    return out[:, 1:, 1:]


def cg_decode(plane: np.ndarray) -> np.ndarray:
    """Fast inverse CG scan: native kernel when available, oracle otherwise."""
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    if _native is not None:
        h, w = plane.shape
        out = _native.cg_decode(plane.tobytes(), w)
        return np.frombuffer(out, np.uint8).reshape(h, w)
    return cg_decode_np(plane)


def cg_encode(plane: np.ndarray) -> np.ndarray:
    """Fast CG residual: native kernel when available, numpy otherwise."""
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    if _native is not None:
        h, w = plane.shape
        out = _native.cg_encode(plane.tobytes(), w)
        return np.frombuffer(out, np.uint8).reshape(h, w)
    return cg_encode_np(plane)
