"""Prev-frame (temporal) prediction study.

The FPVT profile, like the reference (fusion_power_video.cc:517-544),
predicts every frame against ONE static delta frame.  On a device a
batch-internal prev-frame delta is still batch-parallel-decodable: the
inverse is a mod-256 cumulative sum along the frame axis (a cheap
associative scan over B planes), something the reference's frame-at-a-time
decoder was never positioned to exploit.  This script measures what that
buys BEFORE paying for the format/kernel work.

Method: for each bench corpus, all variants run the SAME decision
procedure (per-frame temporal mode by exact wraparound-|residual| cost,
then per-frame spatial predictor none/up/cg2d by exact cost), so the
comparison isolates the temporal-candidate set:

* static: temporal mode in {none, frame0-delta}          (pre-v5 model)
* +prev:  temporal mode in {none, frame0-delta, prev-frame}   (shipped v5)
* +lin:   +prev plus second-order extrapolation 2*prev - prev2 —
          MEASURED AND REJECTED (see the docnote in main())

Sizes are shared-table order-0 batch entropies (matching the rANS coder up
to the table constant, identical on both sides).  The low plane and the
1/16-scale preview plane are included.  Remaining divergences from the
shipped encoder (small, and identical across both variants): previews are
static-only here as in the format; the study decides the low plane's
temporal mode independently where the encoder ties it to the high plane's;
and the low plane is priced order-0 where the encoder ctx16-codes it.

Run: JAX_PLATFORMS=cpu python examples/temporal_study.py [--fast] [--size N D]
"""

from __future__ import annotations

import numpy as np


def entropy_bits(sym: np.ndarray) -> float:
    hist = np.bincount(sym.reshape(-1).astype(np.int64), minlength=256)
    n = hist.sum()
    if n == 0:
        return 0.0
    p = hist[hist > 0] / n
    return float(-(p * np.log2(p)).sum() * n)


def wrap_cost(res: np.ndarray) -> np.ndarray:
    """Per-frame exact wraparound-|residual| cost, [B]."""
    r = res.reshape(res.shape[0], -1).astype(np.int64)
    return np.minimum(r, 256 - r).sum(axis=1)


def best_spatial(plane: np.ndarray) -> np.ndarray:
    """Per-frame best of {none, up, cg2d} by exact cost (same predictor
    set as encode_model_step; exact instead of sampled for study
    precision).  Returns the chosen residual planes."""
    import jax.numpy as jnp

    from fpv_tpu.ops.predict import cg2d_encode, up_encode

    p = jnp.asarray(plane.astype(np.uint8))
    cands = np.stack(
        [plane, np.asarray(up_encode(p)), np.asarray(cg2d_encode(p))]
    )  # [3, B, H, W]
    costs = np.stack([wrap_cost(c) for c in cands])  # [3, B]
    pick = costs.argmin(axis=0)  # [B]
    return cands[pick, np.arange(plane.shape[0])]


def code_plane(plane: np.ndarray, delta: np.ndarray, mode: str,
               spatial: bool = True) -> float:
    """Model one byte plane batch: per-frame temporal mode (exact cost),
    then per-frame spatial mode, then shared-table batch entropy (bits).

    ``mode``: "static" = {none, frame0-delta}; "prev" adds the prev-frame
    candidate (the shipped v5 model); "lin" further adds second-order
    linear extrapolation (2*prev - prev2, mod 256 per byte plane) — a
    candidate that was MEASURED AND REJECTED, see main() docnote.

    Mirrors the SHIPPED encoder policy: every PREV_ANCHOR-th frame is
    barred from the chain-forming candidates (fpvt_codec.PREV_ANCHOR), so
    these numbers estimate — not upper-bound — the implementation's win."""
    from fpv_tpu.api.fpvt_codec import PREV_ANCHOR

    b = plane.shape[0]
    p16 = plane.astype(np.int16)
    cands = [plane, (p16 - delta.astype(np.int16)) % 256]
    if mode in ("prev", "lin"):
        prev = np.concatenate([delta[None], plane[:-1]], axis=0)
        cands.append((p16 - prev.astype(np.int16)) % 256)
    if mode == "lin" and b >= 2:
        prev = np.concatenate([delta[None], plane[:-1]], 0).astype(np.int32)
        prev2 = np.concatenate([delta[None], delta[None], plane[:-2]],
                               0)[:b].astype(np.int32)
        pred = (2 * prev - prev2) % 256
        cands.append((plane.astype(np.int32) - pred) % 256)
    cands = np.stack([c.astype(np.uint8) for c in cands])
    costs = np.stack([wrap_cost(c) for c in cands]).astype(np.float64)
    costs[2:, ::PREV_ANCHOR] = np.inf  # anchor frames: no chain candidates
    if costs.shape[0] > 3:
        # lin at anchor+1 would read plane[anchor-1], crossing the anchor
        # boundary — not expressible under the random-access guarantee
        costs[3, 1::PREV_ANCHOR] = np.inf
    pick = costs.argmin(axis=0)
    chosen = cands[pick, np.arange(b)]
    if spatial:
        chosen = best_spatial(chosen)
    return entropy_bits(chosen)


def study(name: str, frames: np.ndarray, shift: int) -> dict:
    from fpv_tpu.ops.preview import generate_preview

    import jax.numpy as jnp

    imgs = (frames.astype(np.uint16) << shift).astype(np.uint16)
    high = (imgs >> 8).astype(np.uint8)
    low = (imgs & 0xFF).astype(np.uint8)
    pv = np.asarray(generate_preview(jnp.asarray(high)))
    res = {"corpus": name}
    total = {}
    for mode in ("static", "prev", "lin"):
        hb = code_plane(high, high[0], mode)
        lb = code_plane(low, low[0], mode, spatial=False)
        # previews are never USE_PREV-predicted (they stay decodable
        # stand-alone, FORMAT_FPVT.md) — static in both variants
        pb = code_plane(pv, pv[0], "static")
        res[f"{mode}_high_bits"] = hb
        res[f"{mode}_low_bits"] = lb
        res[f"{mode}_pv_bits"] = pb
        total[mode] = hb + lb + pb
    res["static_total_bits"] = total["static"]
    res["prev_total_bits"] = total["prev"]
    res["lin_total_bits"] = total["lin"]
    res["save_pct"] = (
        100.0 * (1 - total["prev"] / total["static"])
        if total["static"] > 0 else 0.0
    )
    res["lin_vs_prev_pct"] = (
        100.0 * (1 - total["lin"] / total["prev"])
        if total["prev"] > 0 else 0.0
    )
    return res


def pan_frames(n: int, d: int, step: float = 0.4, seed: int = 5) -> np.ndarray:
    """Smooth sub-pixel pan: one plasma field sampled at a fractional
    offset that advances ``step`` px/frame (bilinear interpolation), the
    motion class where second-order extrapolation should shine if ever."""
    from fpv_tpu.utils import testdata

    base = testdata.plasma_frames(1, d * 2, d * 2, bits=12, seed=seed)[0]
    base = base.astype(np.float64)
    out = np.empty((n, d, d), np.uint16)
    for i in range(n):
        off = i * step
        i0, f = int(np.floor(off)), off - np.floor(off)
        a = base[i0:i0 + d, i0:i0 + d]
        b = base[i0 + 1:i0 + 1 + d, i0:i0 + d]
        c = base[i0:i0 + d, i0 + 1:i0 + 1 + d]
        e = base[i0 + 1:i0 + 1 + d, i0 + 1:i0 + 1 + d]
        out[i] = np.clip((a * (1 - f) * (1 - f) + b * f * (1 - f)
                          + c * (1 - f) * f + e * f * f), 0, 4095
                         ).astype(np.uint16)
    return out


def main():
    import sys

    from fpv_tpu.utils import testdata

    n, d = (4, 128) if "--fast" in sys.argv else (16, 512)
    if "--size" in sys.argv:
        i = sys.argv.index("--size")
        n, d = int(sys.argv[i + 1]), int(sys.argv[i + 2])
    rng = np.random.default_rng(0)
    pl = testdata.plasma_frames(n, d, d, bits=12, seed=5).astype(np.int32)
    dark = rng.poisson(50, (n, d, d)).astype(np.uint16)
    dark[rng.random((n, d, d)) < 1e-4] = 4000
    corpora = [
        ("plasma12s", testdata.plasma_frames(n, d, d, bits=12, seed=5), 4),
        ("noise16", testdata.noise_frames(n, d, d, bits=16), 0),
        ("ramp12s", np.tile((np.arange(d * d) % 4096).astype(np.uint16)
                            .reshape(1, d, d), (n, 1, 1)), 4),
        ("mixed12", np.clip(pl + rng.normal(0, 8, pl.shape), 0, 4095)
         .astype(np.uint16), 4),
        ("dark12", dark, 4),
        ("drift12", np.stack([np.roll(pl[0], (i, i), (0, 1))
                              for i in range(n)]).astype(np.uint16), 4),
        ("pan12", pan_frames(n, d), 4),
    ]
    # The "lin" column is a RECORDED NEGATIVE RESULT (round 4, boundary
    # sharpened round 5): adding second-order linear extrapolation
    # (2*prev - prev2) as a 4th temporal mode.  The wrap-|residual|
    # decision picks it on every drifting corpus, yet total coded size
    # GROWS (16x256x256: plasma -7.0%, mixed -7.2%, drift -10.9% vs prev)
    # — on independently-wrapping byte planes the second difference
    # doubles carry noise and smears the shared table, and |residual|
    # misranks it against the first-order candidate.  The one exception is
    # pan12 (noise-FREE bilinear sub-pixel pan: +11.4%), and it is fragile:
    # adding gaussian sensor noise of sigma 0.5/1/2 DN (12-bit scale)
    # drops the win to +6.1/+0.8/-4.0% — below any realistic shot-noise
    # floor.  A viable lin mode would need u16-domain prediction (a format
    # break) or an entropy-aware decision; no realistic corpus justifies
    # either.
    print(f"{'corpus':<10} {'static kB':>10} {'+prev kB':>10} {'save%':>7} "
          f"{'+lin kB':>9} {'lin_vs_prev%':>12}")
    for name, frames, shift in corpora:
        r = study(name, frames, shift)
        print(f"{r['corpus']:<10} {r['static_total_bits']/8192:10.1f} "
              f"{r['prev_total_bits']/8192:10.1f} {r['save_pct']:7.2f} "
              f"{r['lin_total_bits']/8192:9.1f} {r['lin_vs_prev_pct']:12.2f}")


if __name__ == "__main__":
    main()
