"""High-plane context-model study.

Measures, on the six bench corpora, how much a conditional entropy model
on the HIGH plane could save over the shipping order-0 tables — BEFORE
paying for a kernel.  Contexts evaluated:

* prev-step   — the symbol 1024 flat positions back: the only context the
  block-interleaved decode kernel gets for free (it is the previous step's
  decoded vector, same mechanism the low plane's ctx16 mode uses —
  fpv_tpu/ops/rans_layout.py CODING_CTX16).
* W-neighbor  — flat position -1: spatially adjacent, but NOT available
  in-kernel (lanes decode 1024 consecutive positions concurrently).
  Upper bound for any same-row spatial model.
* W+N joint   — classic 2-D context, decoder-infeasible here; dream bound.

Symbols are the actual coded high plane: encode_model_step output (delta +
spatial prediction applied, same decisions as the shipping encoder).
Context values are bucketed by residual magnitude (log2 buckets, 8 ctx);
conditional entropies include the per-context table cost a real stream
would carry (nctx*256 12-bit probabilities, amortized over the batch).

Run: JAX_PLATFORMS=cpu python examples/ctx_study.py
Reference stance being tested:
"only the entropy coding matters" (fusion_power_video.cc:166-169).
"""

import numpy as np


def bucket(sym: np.ndarray) -> np.ndarray:
    """Residual-magnitude log2 buckets: 8 contexts."""
    m = np.minimum(sym.astype(np.int32), 256 - sym.astype(np.int32))
    # 0,1,2,3-4,5-8,9-16,17-32,>32
    return np.digitize(m, [1, 2, 3, 5, 9, 17, 33]).astype(np.int32)


def entropy_bits(hist: np.ndarray) -> float:
    n = hist.sum()
    if n == 0:
        return 0.0
    p = hist[hist > 0] / n
    return float(-(p * np.log2(p)).sum() * n)


def cond_entropy_bits(ctx: np.ndarray, sym: np.ndarray, nctx: int) -> float:
    joint = np.zeros((nctx, 256), np.int64)
    np.add.at(joint, (ctx, sym), 1)
    return sum(entropy_bits(joint[c]) for c in range(nctx))


def study(name: str, frames: np.ndarray, shift: int) -> dict:
    import jax
    from fpv_tpu.api import fpvt_codec as fp

    imgs = jax.numpy.asarray((frames << shift).astype(np.uint16))
    delta = imgs[0]
    dh, dl = (delta >> 8).astype(jax.numpy.uint8), delta.astype(jax.numpy.uint8)
    out = fp.encode_model_step(imgs, dh, dl, shift=0)
    high = np.asarray(out["high"]).astype(np.uint8)
    b = high.shape[0]
    flat = high.reshape(b, -1)  # per-frame flat stream, scan order
    s = flat.reshape(-1).astype(np.int64)
    n = s.size
    h0 = entropy_bits(np.bincount(s, minlength=256))

    # prev-step context: flat position -1024 within each frame (step 0 sees
    # zeros, matching the kernels' zero history)
    prev = np.zeros_like(flat)
    prev[:, 1024:] = flat[:, :-1024]
    cw = np.zeros_like(flat)
    cw[:, 1:] = flat[:, :-1]
    w_img = high.shape[2]
    cn = np.zeros_like(flat)
    cn[:, w_img:] = flat[:, :-w_img]

    nctx = 8
    table_bits = nctx * 256 * 12  # per-ctx 12-bit prob tables in the stream
    res = {"corpus": name, "syms": n, "order0_bps": h0 / n}
    for label, carr, nc in (
        ("prev_step", bucket(prev.reshape(-1)), nctx),
        ("w_neighbor", bucket(cw.reshape(-1)), nctx),
        ("wn_joint", bucket(cw.reshape(-1)) * nctx + bucket(cn.reshape(-1)),
         nctx * nctx),
    ):
        hc = cond_entropy_bits(carr, s, nc) + nc * 256 * 12
        res[label + "_bps"] = hc / n
        # h0 == 0: constant residual plane (CODING_CONST territory) — a ctx
        # model is moot; report 0 saving
        res[label + "_save_pct"] = (
            100.0 * (1 - hc / h0) if h0 > 0 else 0.0
        )
    return res


def main():
    import sys

    from fpv_tpu.utils import testdata

    # --fast: tiny corpora so the script stays CI-runnable (meaningful
    # numbers come from the full size)
    n, d = (4, 128) if "--fast" in sys.argv else (16, 512)
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
    ]
    print(f"{'corpus':<10} {'order0':>7} {'prev':>7} {'save%':>6} "
          f"{'W':>7} {'save%':>6} {'W+N':>7} {'save%':>6}")
    for name, frames, shift in corpora:
        r = study(name, frames, shift)
        print(f"{r['corpus']:<10} {r['order0_bps']:7.4f} "
              f"{r['prev_step_bps']:7.4f} {r['prev_step_save_pct']:6.2f} "
              f"{r['w_neighbor_bps']:7.4f} {r['w_neighbor_save_pct']:6.2f} "
              f"{r['wn_joint_bps']:7.4f} {r['wn_joint_save_pct']:6.2f}")


if __name__ == "__main__":
    main()
