"""Smoke test of the FPVT device codec on one GPU (or four, with --four).

    python chip_smoke.py           # one card: kernels, main path, fixtures
    python chip_smoke.py --four    # four cards: sharded file codec + hubs

Every phase prints one line with its outcome and wall time; a failing
phase raises and the script exits non-zero.  The first line is the card's
name and power limit as nvidia-smi reports them; the last line is one JSON
object naming the device as JAX reports it.  Without a GPU (or without the
rest of the repository beside it) the script fails before printing that
line.
"""

from __future__ import annotations

import argparse
import collections
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

SHIFT = 4
CHUNK_LOG2 = 12
FPB = 128  # frames per batch of the main path
CORPUS = (2 * FPB, 1024, 1024)  # frames, height, width
CG_SHAPES = ((128, 1024, 1024), (4, 4096, 4096))
LARGE = 4096  # large-frame side
HUB_SIZE = 1024


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise SystemExit(f"no GPU: nvidia-smi failed ({e})")
    return out.strip().splitlines()[0]


def phase(name: str):
    """Decorator: run the phase, print '[name] ok <s> s <detail>' (the
    detail is the phase's result when that is a string)."""

    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            detail = result if isinstance(result, str) else ""
            print(f"[{name}] ok {dt:.1f} s {detail}".rstrip(), flush=True)
            return result

        return run

    return deco


CALLS: collections.Counter = collections.Counter()


def count_calls(module, name: str) -> None:
    """Wrap module.name so every call is counted in CALLS."""
    fn = getattr(module, name)

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        CALLS[name] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)


# ---------------------------------------------------------------------------
# one card


@phase("device")
def check_device(expect: int):
    import jax

    from fpv_tpu import backend

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    if len(devs) < expect:
        raise SystemExit(f"needs {expect} GPUs, JAX sees {len(devs)}")
    if backend.engine() != "gpu" or backend.interpret():
        raise AssertionError(f"dispatch chose {backend.engine()!r}")
    return (f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
            f"engine {backend.engine()} (compiled kernels)")


@phase("corpus")
def make_corpus():
    from fpv_tpu.utils import testdata

    return testdata.plasma_frames(*CORPUS, bits=12, seed=1)


def _rans_plane(name, plane, k, ctx):
    """Kernel encode/decode of one flat plane vs the numpy oracle given
    the same table; tolerance 0."""
    import jax.numpy as jnp

    from fpv_tpu import backend
    from fpv_tpu.entropy.plane_codec import _interleave_np
    from fpv_tpu.entropy.tables import normalize_freqs, normalize_freqs_ctx
    from fpv_tpu.ops import rans_numpy as rn
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import BLOCK_LANES, chunk_lens

    n = plane.size
    lens = chunk_lens(1, n, k)
    nb = len(lens) // BLOCK_LANES
    il = _interleave_np(plane.reshape(1, -1), k, nb)
    if ctx:
        idx = rn.encode_ctx_indices(il, lens)
        m = np.arange(k)[None, :] < lens[:, None]
        jh = np.bincount(idx[m], minlength=512)
        freq = normalize_freqs_ctx(jh, floor_mask=jh > 0)
        _f, cum, _s = rn.ctx_tables(freq)
        st, cnt, pay = rn.encode_blocks(idx, lens, freq, prob_bits=7, cum=cum)
        enc_t, dec_t, pb = rt.ctx_encode_table(freq), rt.ctx_fused_table(freq), 7
    else:
        h = np.bincount(plane, minlength=256)
        freq = normalize_freqs(h, ensure_all=True, floor_mask=h > 0)
        st, cnt, pay = rn.encode_blocks(il, lens, freq)
        enc_t, dec_t, pb = rt.encode_table(freq), rt.fused_table(freq), 12
    flat = np.zeros(nb * k * BLOCK_LANES, np.uint8)
    flat[:n] = plane
    s2, w2, c2 = rt.encode(
        jnp.asarray(flat.reshape(nb, k, BLOCK_LANES)), jnp.asarray(lens),
        jnp.asarray(enc_t), k, prob_bits=pb, ctx_mode=ctx,
        interpret=backend.interpret(),
    )
    s2, w2, c2 = np.asarray(s2), np.asarray(w2), np.asarray(c2)
    p2 = np.concatenate([w2[g, : c2[g]] for g in range(len(c2))])
    if not (np.array_equal(s2.reshape(-1), st) and np.array_equal(c2, cnt)
            and np.array_equal(p2, pay)):
        raise AssertionError(f"{name}: kernel encode differs from numpy")
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    out, ok = rt.decode(
        jnp.asarray(cnt.astype(np.int32)), jnp.asarray(starts),
        jnp.asarray(pay), jnp.asarray(st.reshape(nb, BLOCK_LANES)),
        jnp.asarray(lens), jnp.asarray(dec_t), k, prob_bits=pb, ctx_mode=ctx,
        interpret=backend.interpret(),
    )
    if not (np.asarray(ok).all()
            and np.array_equal(np.asarray(out).reshape(-1)[:n], plane)):
        raise AssertionError(f"{name}: kernel decode differs from input")
    return f"{name} {n} syms K={k} {nb} blocks {pay.size} words"


@phase("kernels-rans")
def check_rans(frames):
    import jax.numpy as jnp

    from fpv_tpu.api.fpvt_codec import PV_CHUNK_MAX, encode_model_step

    z = jnp.zeros(frames.shape[1:], jnp.uint8)
    m = encode_model_step(
        jnp.asarray(frames[:FPB]), z, z, SHIFT, False, False, True, False
    )
    k = 1 << CHUNK_LOG2
    parts = [
        _rans_plane("high/order0", np.asarray(m["high"]).reshape(-1), k,
                    False),
        _rans_plane("low/ctx16",
                    (np.asarray(m["low"]).reshape(-1) >> 4).astype(np.uint8),
                    k, True),
        _rans_plane("preview", np.asarray(m["preview"]).reshape(-1),
                    PV_CHUNK_MAX, False),
    ]
    return "bit-exact vs rans_numpy: " + "; ".join(parts)


@phase("kernels-cg2d")
def check_cg2d():
    import jax
    import jax.numpy as jnp

    from fpv_tpu.models.predictors import cg2d_decode_np
    from fpv_tpu.ops import predict

    out = []
    for shape in CG_SHAPES:
        key = jax.random.key(sum(shape))
        x = jax.random.randint(key, shape, 0, 256, jnp.int32).astype(jnp.uint8)
        x = x // 4 + jnp.arange(shape[2], dtype=jnp.uint8)[None, None, :]
        res = predict.cg2d_encode(x)
        if not bool(jnp.array_equal(predict.cg2d_decode(res), x)):
            raise AssertionError(f"cg2d kernel {shape} != cg2d_encode inverse")
        out.append(str(list(shape)))
    small = np.asarray(x[:1, :300, :200])
    res_s = np.asarray(predict.cg2d_encode(small))
    if not np.array_equal(np.asarray(predict.cg2d_decode(res_s)),
                          cg2d_decode_np(res_s)):
        raise AssertionError("cg2d kernel differs from the numpy wavefront")
    return "inverts cg2d_encode at " + ", ".join(out) + "; == numpy wavefront"


@phase("kernels-tables")
def check_tables():
    import jax.numpy as jnp

    from fpv_tpu.entropy.tables_device import fused_decode_tables_device
    from fpv_tpu.ops import rans_triton as rt

    rng = np.random.default_rng(4)
    for big in (2049, 3001, 4000, 4096):
        rest = 4096 - big
        cuts = np.sort(rng.integers(0, rest + 1, 3))
        freq = np.zeros(256, np.uint32)
        syms = rng.choice(256, 5, replace=False)
        freq[syms[:4]] = np.diff(np.r_[0, cuts, rest])
        freq[syms[4]] = big
        dev = np.asarray(fused_decode_tables_device(jnp.asarray(freq)))
        if not np.array_equal(dev, rt.fused_table(freq)):
            raise AssertionError(f"device tables differ (max freq {big})")
    return "fused_decode_tables_device == host for entries up to 4096"


@phase("main-path")
def check_main_path(frames):
    import jax
    import jax.numpy as jnp

    from fpv_tpu.api import fpvt_codec as fc
    from fpv_tpu.ops import rans_numpy
    from fpv_tpu.ops.planes import split_planes
    from fpv_tpu.ops.preview import generate_preview

    for name in ("fused_encode_batch", "fused_decode_batch",
                 "fused_decode_frame", "fused_decode_preview"):
        count_calls(fc, name)
    for name in ("encode_blocks", "decode_blocks", "decode_blocks_ctx"):
        count_calls(rans_numpy, name)
    h, w = frames.shape[1:]
    t0 = time.perf_counter()
    wtr = fc.FpvtWriter(w, h, shift=SHIFT, chunk_log2=CHUNK_LOG2,
                        frames_per_batch=FPB, narrow=False)
    data = wtr.init(frames[0])
    for i in range(0, len(frames), FPB):
        data += wtr.encode_batch(frames[i : i + FPB])
    data += wtr.finish()
    t_enc = time.perf_counter() - t0
    host_calls = CALLS["encode_blocks"]
    if CALLS["fused_encode_batch"] != 2 or host_calls:
        raise AssertionError(f"writer did not take the device path: {CALLS}")
    want = (frames.astype(np.uint32) << SHIFT).astype(np.uint16)

    t0 = time.perf_counter()
    rdr = fc.FpvtReader(data)
    got = np.concatenate([rdr.decode_batch(i) for i in range(rdr.num_batches)])
    t_dec = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError("FpvtReader output differs from the input")
    if CALLS["fused_decode_batch"] != 2 or CALLS["decode_blocks"]:
        raise AssertionError(f"reader did not take the device path: {CALLS}")
    del got

    rng = np.random.default_rng(7)
    rdr2 = fc.FpvtReader(data)  # no batch cache: per-frame programs
    idx = sorted(rng.choice(len(frames), 4, replace=False).tolist())
    for i in idx:
        if not np.array_equal(rdr2.decode_frame(i), want[i]):
            raise AssertionError(f"decode_frame({i}) differs")
    pv_want = jax.jit(lambda x: generate_preview(split_planes(x, SHIFT, False)[0]))
    for i in rng.choice(len(frames), 4, replace=False).tolist():
        exp = np.asarray(pv_want(jnp.asarray(frames[i : i + 1])))[0]
        if not np.array_equal(rdr2.preview_frame(i), exp):
            raise AssertionError(f"preview_frame({i}) differs")
    if not (CALLS["fused_decode_frame"] and CALLS["fused_decode_preview"]):
        raise AssertionError(f"random access missed the device path: {CALLS}")

    os.environ["FPV_TPU_RANS_ENGINE"] = "numpy"
    try:
        rdr3 = fc.FpvtReader(data)
        host = np.concatenate(
            [rdr3.decode_batch(i) for i in range(rdr3.num_batches)]
        )
    finally:
        del os.environ["FPV_TPU_RANS_ENGINE"]
    if not CALLS["decode_blocks"] or not np.array_equal(host, want):
        raise AssertionError("numpy host engine decode differs")
    mpix = frames.size / 1e6
    return (
        f"{len(frames)}x{h}x{w} 12-bit plasma, {len(data)} bytes "
        f"({8 * len(data) / frames.size:.3f} bpp); fused writer "
        f"{mpix / t_enc:.1f} Mpix/s, fused reader {mpix / t_dec:.1f} Mpix/s "
        "(wall, compiles included); decode_frame x4 and preview_frame x4 "
        "exact; numpy host engine decodes the same pixels (file bytes are "
        "not compared with a CPU encode: float32 histogram sums may round "
        "differently there)"
    )


@phase("golden")
def check_golden():
    from fpv_tpu.api.decoder import decode_file
    from fpv_tpu.api.fpvt_codec import decode_file_fpvt

    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "golden")
    with open(os.path.join(gold, "hashes.json")) as f:
        pins = json.load(f)
    with np.load(os.path.join(gold, "inputs.npz")) as z:
        drift = (z["drift"].astype(np.uint16) << 4).astype(np.uint16)
        noise = z["noise16"]
    names = sorted(n for n in os.listdir(gold) if n.endswith((".fpvt", ".fpv")))
    for name in names:
        with open(os.path.join(gold, name), "rb") as f:
            blob = f.read()
        if name in pins and hashlib.sha256(blob).hexdigest() != pins[name]:
            raise AssertionError(f"{name}: bytes differ from hashes.json")
        out = decode_file(blob) if name.endswith(".fpv") else decode_file_fpvt(
            blob)
        if not np.array_equal(out, noise if "raw" in name else drift):
            raise AssertionError(f"{name}: decoded pixels differ")
    return f"{len(names)} fixtures decode; pinned hashes match"


@phase("large-frames")
def check_large():
    from fpv_tpu.api.fpvt_codec import FpvtReader, FpvtWriter
    from fpv_tpu.utils import testdata

    frames = testdata.plasma_frames(5, LARGE, LARGE, bits=12, seed=2)
    wtr = FpvtWriter(LARGE, LARGE, shift=SHIFT, frames_per_batch=4,
                     narrow=False)
    data = wtr.init(frames[0]) + wtr.encode_batch(frames[1:]) + wtr.finish()
    got = FpvtReader(data).decode_batch(0)
    if not np.array_equal(got, frames[1:].astype(np.uint16) << SHIFT):
        raise AssertionError("4x4096^2 roundtrip differs")
    return f"4x{LARGE}x{LARGE} lossless, {len(data)} bytes"


def _hub_roundtrip(nstreams, size, nframes, devices=None):
    from fpv_tpu.api.multistream import MultiStreamDecoder, MultiStreamEncoder
    from fpv_tpu.utils import testdata

    cams = {f"cam{i}": testdata.plasma_frames(nframes + 1, size, size,
                                              bits=12, seed=10 + i)
            for i in range(nstreams)}
    files = {sid: [] for sid in cams}
    enc = MultiStreamEncoder(size, size, shift=SHIFT, frames_per_batch=16,
                             sink=lambda sid, b: files[sid].append(b),
                             devices=devices)
    for sid, fr in cams.items():
        enc.add_stream(sid, fr[0])
    for i in range(1, nframes + 1):
        for sid, fr in cams.items():
            enc.push_frame(sid, timestamp=i, frame=fr[i])
    enc.close()
    got = {sid: [] for sid in cams}
    dec = MultiStreamDecoder(sink=lambda sid, imgs, ts: got[sid].append(imgs),
                             devices=devices)
    for sid in cams:
        dec.add_stream(sid)
        for chunk in files[sid]:
            dec.feed(sid, chunk)
    dec.close()
    for sid, fr in cams.items():
        if not np.array_equal(np.concatenate(got[sid]),
                              fr[1:].astype(np.uint16) << SHIFT):
            raise AssertionError(f"hub stream {sid} differs")
    return f"{nstreams} streams x {nframes} frames at {size}^2 lossless"


@phase("hubs")
def check_hubs():
    return _hub_roundtrip(2, HUB_SIZE, 48)


# ---------------------------------------------------------------------------
# four cards


@phase("four-sharded-file")
def check_sharded_file():
    import jax

    from fpv_tpu.api.fpvt_codec import encode_file_fpvt
    from fpv_tpu.parallel import mesh as pmesh
    from fpv_tpu.utils import testdata

    mesh = pmesh.make_mesh(4, data=4)
    frames = testdata.plasma_frames(1 + 2 * 4 * 16, HUB_SIZE, HUB_SIZE,
                                    bits=12, seed=3)
    kw = dict(shift=SHIFT, frames_per_batch=16, chunk_log2=CHUNK_LOG2)
    sharded = pmesh.sharded_encode_file(frames, mesh, **kw)
    single = encode_file_fpvt(frames, **kw)
    if sharded != single:
        raise AssertionError("sharded_encode_file differs from the writer")
    out = pmesh.sharded_decode_file(sharded, mesh)
    if not np.array_equal(out, frames.astype(np.uint16) << SHIFT):
        raise AssertionError("sharded_decode_file is not lossless")
    return (f"{len(frames)}x{HUB_SIZE}^2 over {mesh.devices.size} x "
            f"{jax.devices()[0].device_kind}: byte-identical, lossless")


@phase("four-dryrun")
def check_dryrun():
    from fpv_tpu.parallel.mesh import multichip_dryrun

    multichip_dryrun(4)
    return "multichip_dryrun(4) ok"


@phase("four-hubs")
def check_hubs_four():
    import jax

    return _hub_roundtrip(4, HUB_SIZE, 32, devices=jax.devices()[:4])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args()
    print(card_line(), flush=True)
    ndev = 4 if args.four else 1
    check_device(ndev)
    if args.four:
        check_sharded_file()
        check_dryrun()
        check_hubs_four()
    else:
        frames = make_corpus()
        check_rans(frames)
        check_cg2d()
        check_tables()
        check_main_path(frames)
        del frames
        check_golden()
        check_large()
        check_hubs()
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
