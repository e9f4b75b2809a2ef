"""Multi-chip scaling: device meshes and sharded codec steps.

The reference's parallelism is a worker-thread pool over frames
(fusion_power_video.cc:1199-1230).  The device equivalent is data
parallelism over a device mesh: frames shard over the ``data`` axis and,
for very large frames, rows shard over the ``space`` axis.  XLA/GSPMD
inserts the collectives (histogram psums; halo exchanges for the
preview/prediction rolls are neighbour permutes).

Streams are independent — there is no cross-replica dependency in the codec
itself — so scaling efficiency is near-linear; only the (tiny) histogram
reductions cross shards.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: int | None = None, data: int | None = None, space: int = 1
) -> Mesh:
    """Build a (data, space) mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if data is None:
        data = n_devices // space
    grid = np.array(devs[: data * space]).reshape(data, space)
    return Mesh(grid, axis_names=("data", "space"))


def shard_frames(imgs: jax.Array | np.ndarray, mesh: Mesh) -> jax.Array:
    """Place [B, H, W] frames with B over 'data' and H over 'space'."""
    sharding = NamedSharding(mesh, P("data", "space", None))
    return jax.device_put(jnp.asarray(imgs), sharding)


def sharded_encode_model_step(mesh: Mesh, shift: int = 0, big_endian: bool = False):
    """Returns a jitted model step that runs sharded over ``mesh``.

    The returned function takes ([B,H,W] u16, delta_high, delta_low) and
    produces the same outputs as fpv_tpu.api.fpvt_codec.encode_model_step;
    GSPMD partitions the batch over 'data' and rows over 'space'.
    """
    from fpv_tpu.api.fpvt_codec import encode_model_step

    in_shardings = (
        NamedSharding(mesh, P("data", "space", None)),
        NamedSharding(mesh, P("space", None)),
        NamedSharding(mesh, P("space", None)),
    )

    @functools.partial(jax.jit, in_shardings=in_shardings)
    def step(imgs, delta_high, delta_low):
        return encode_model_step(imgs, delta_high, delta_low, shift, big_endian)

    return step


def _local_codec_roundtrip(
    imgs: jax.Array,
    delta_high: jax.Array,
    delta_low: jax.Array,
    *,
    shift: int,
    big_endian: bool,
    chunk_len: int,
    axis: str | None,
):
    """The FULL fused codec, shard-local: model step -> device tables ->
    rANS encode kernels -> rANS decode kernels -> inverse predictors ->
    plane combine.  With ``axis`` set, histogram psums build globally-shared
    frequency tables (the one collective; everything else is per-shard —
    streams/batches are independent, matching the reference's frame-level
    data parallelism, fusion_power_video.cc:1199-1230).

    Returns (reconstructed imgs, ok) where ok aggregates the rANS state
    integrity checks, the preview roundtrip and the pixel-exact compare.
    """
    from fpv_tpu.api.fpvt_codec import (
        _apply_temporal_and_combine,
        _inverse_spatial,
        _plane_geometry,
        encode_model_step,
    )
    from fpv_tpu.entropy.plane_codec import (
        _from_block_symbols,
        _to_block_symbols,
    )
    from fpv_tpu.entropy.tables_device import (
        encode_tables_device,
        fused_decode_tables_device,
        normalize_freqs_device,
    )
    from fpv_tpu import backend
    from fpv_tpu.ops import rans_triton as rt
    from fpv_tpu.ops.rans_layout import BLOCK_LANES

    b, h, w = imgs.shape
    m = encode_model_step(
        imgs, delta_high, delta_low, shift, big_endian, allow_prev=True
    )
    rec = {}
    oks = []
    for name, s in (("high", h * w), ("low", h * w),
                    ("preview", (h // 4) * (w // 4))):
        hist = m[f"hist_{name}"]
        mask = m[f"mask_{name}"]
        if axis is not None:
            hist = jax.lax.psum(hist, axis)
            # support-mask union across shards (OR via psum)
            mask = (jax.lax.psum(mask, axis) > 0).astype(jnp.int32)
        freq = normalize_freqs_device(hist, mask)
        lens, nblocks = _plane_geometry(b, s, chunk_len)
        syms = _to_block_symbols(m[name].reshape(b, -1), chunk_len, nblocks)
        lens_dev = jnp.asarray(lens.reshape(nblocks, BLOCK_LANES))
        interpret = backend.interpret()
        states, words, counts = rt.encode(
            syms, lens_dev, encode_tables_device(freq), chunk_len,
            interpret=interpret,
        )
        # decode straight from the staging rows: group g starts at g * L
        starts = jnp.arange(words.shape[0], dtype=jnp.int32) * words.shape[1]
        syms2, ok = rt.decode(
            counts, starts, words.reshape(-1), states, lens_dev,
            fused_decode_tables_device(freq), chunk_len, interpret=interpret,
        )
        rec[name] = _from_block_symbols(syms2, b, s, chunk_len)
        oks.append(jnp.all(ok == 1))
    high = _inverse_spatial(
        rec["high"].reshape(b, h, w), m["spatial"], True, True
    )
    out = _apply_temporal_and_combine(
        high, rec["low"].reshape(b, h, w), m["use_delta"], m["use_prev"],
        delta_high, delta_low, any_prev=True,
    )
    pv_ok = jnp.all(rec["preview"] == m["preview"].reshape(b, -1))
    ok_all = jnp.all(jnp.stack(oks)) & pv_ok & jnp.all(out == imgs)
    if axis is not None:
        # replicate the verdict so it is a legal replicated output
        ok_all = jax.lax.psum(ok_all.astype(jnp.int32), axis) == jax.lax.psum(
            jnp.int32(1), axis
        )
    return out, ok_all


def sharded_codec_roundtrip(
    mesh: Mesh,
    chunk_len: int = 64,
    shift: int = 0,
    big_endian: bool = False,
):
    """One jitted program running the FULL codec data-parallel over ``mesh``:
    frames shard over 'data', the rANS kernels run on per-shard blocks, and
    table histograms psum across devices.  Returns f(imgs, dh, dl) ->
    (reconstructed imgs, ok)."""
    from jax import shard_map

    fn = functools.partial(
        _local_codec_roundtrip,
        shift=shift,
        big_endian=big_endian,
        chunk_len=chunk_len,
        axis="data",
    )
    sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("data", None, None), P(None, None), P(None, None)),
        out_specs=(P("data", None, None), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_fused_encode(
    mesh: Mesh,
    shift: int = 0,
    big_endian: bool = False,
    chunk_len: int = 512,
    use_delta_frame: bool = True,
    low_coding: int = 0,
    allow_prev: bool = False,
):
    """shard_map of the production fused_encode_batch program: each device
    encodes its local frames into independent rANS streams (shard-local
    tables and blocks).  Returns f(imgs, dh, dl) -> (small, states,
    payload_high, payload_low, payload_preview), each the concatenation of
    the per-device outputs along axis 0 — bit-identical to running
    fused_encode_batch on each device's frame slice separately (tested in
    tests/test_parallel.py).  ``low_coding=CODING_CTX16`` runs the shipping
    configuration (context-coded low plane, fpvt_codec FpvtWriter default
    for shift >= 4)."""
    from jax import shard_map

    from fpv_tpu.api.fpvt_codec import fused_encode_batch

    def fn(imgs, dh, dl):
        return fused_encode_batch(
            imgs, dh, dl, shift, big_endian, chunk_len, use_delta_frame,
            low_coding, allow_prev,
        )

    sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("data", None, None), P(None, None), P(None, None)),
        out_specs=(P("data"),) * 5,
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def _sharded_decode_program(
    mesh: Mesh,
    chunk_len: int,
    b: int,
    h: int,
    w: int,
    decode_preview: bool,
    static_items: tuple,
):
    from jax import shard_map

    from fpv_tpu.api.fpvt_codec import fused_decode_batch

    static = dict(static_items)

    def fn(payload, plane_offs, counts, states, flags, tables,
           dh, dl, const_vals):
        out = fused_decode_batch(
            payload[0], plane_offs[0], counts[0], states[0], flags[0],
            tables[0], dh, dl, const_vals[0],
            chunk_len=chunk_len, b=b, h=h, w=w,
            decode_preview=decode_preview, pack_u8=True, **static,
        )
        # pack_u8: frames leave each device as their little-endian byte
        # stream [b*h, 2w] u8 (the bitcast fuses into the output copy) —
        # callers view the bytes back as '<u2'
        if decode_preview:
            imgs, ok, pv = out
            return imgs[None], ok.reshape(1), pv[None]
        imgs, ok = out
        return imgs[None], ok.reshape(1)

    nout = 3 if decode_preview else 2
    sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("data"),) * 6 + (P(None, None), P(None, None), P("data")),
        out_specs=(P("data"),) * nout,
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_fused_decode(
    mesh: Mesh,
    *,
    chunk_len: int,
    b: int,
    h: int,
    w: int,
    decode_preview: bool = False,
    **static,
):
    """shard_map of the production fused_decode_batch program: each device
    decodes ONE batch section (stacked along the leading axis, P('data')).

    Takes the stacked outputs of fpvt_codec.batch_decode_args — payload
    [D, L], plane_offs [D, 3], counts [D, C], states [D, S], flags [D, B],
    tables [D, 3, PROB_SCALE] — plus the shared
    (replicated) delta planes and const_vals [D, 3].  Returns
    (imgs [D, B*H, 2W] u8 little-endian byte stream — view as '<u2' on the
    host, see fused_decode_batch pack_u8 — and ok [D] bool; with
    ``decode_preview`` a third output, previews [D, B, H//4, W//4] u8),
    pixel-exact vs running fused_decode_batch on each section separately
    (tested in tests/test_parallel.py).  ``static`` carries batch_decode_args's static
    kwargs; bool flags must be the UNION over the stacked sections.

    The serving counterpart of sharded_fused_encode: D batch sections of a
    stream (or D independent streams) decode concurrently across the mesh —
    the multi-chip generalization of the reference's frame-level decode
    parallelism (fusion_power_video.cc:296-347 driven per frame)."""
    return _sharded_decode_program(
        mesh, chunk_len, b, h, w, decode_preview,
        tuple(sorted(static.items())),
    )


def sharded_decode_file(data: bytes, mesh: Mesh, want_previews: bool = False):
    """Decode an FPVT file's batch sections data-parallel over ``mesh``.

    Sections group by decode signature (frames per batch, const-plane set,
    low coding); each full group of mesh-size sections decodes as ONE
    sharded program, remainders fall back to the single-device reader.
    Host packaging, uploads, device compute, and frame pulls pipeline two
    deep: group g+1 packages on a worker thread while group g computes and
    group g-1's frames download.  Returns all frames [N, H, W] u16
    (left-aligned) in file order — or ``(frames, previews [N, H//4, W//4]
    u8)`` with ``want_previews`` (previews decode inside the same sharded
    programs).  Expects a data-only mesh (space axis of size 1)."""
    from concurrent.futures import ThreadPoolExecutor

    from fpv_tpu.api.fpvt_codec import (
        FpvtReader,
        _fused_decodable,
        batch_decode_args,
    )
    from fpv_tpu.format import fpvt as _fpvt
    from fpv_tpu.ops.rans_layout import CODING_CONST, CODING_RAW

    rdr = FpvtReader(data)
    ndev = mesh.shape["data"]
    h, w = rdr.header.ysize, rdr.header.xsize
    k = 1 << rdr.header.chunk_log2
    results: dict[int, np.ndarray] = {}
    groups: dict[tuple, list] = {}
    leftovers: list[tuple[int, "_fpvt.ParsedBatch", int]] = []
    for bi, (off, n) in enumerate(rdr._batches):
        pb = rdr._parse_batch(off)
        if not _fused_decodable(pb, k):
            leftovers.append((bi, pb, n))
            continue
        streams = (pb.high, pb.low, pb.preview)
        const_planes = tuple(st.coding == CODING_CONST for st in streams)
        raw_planes = tuple(st.coding == CODING_RAW for st in streams)
        key = (n, const_planes, raw_planes, bool(pb.low.coding == 1))
        groups.setdefault(key, []).append((bi, pb))
    # flatten full mesh-sized groups into an ordered work list; remainders
    # join the leftovers
    units: list[tuple[int, list]] = []
    for (n, _const, _raw, _lowctx), items in groups.items():
        while len(items) >= ndev:
            units.append((n, items[:ndev]))
            items = items[ndev:]
        leftovers.extend((bi, pb, n) for bi, pb in items)

    sharding = NamedSharding(mesh, P("data"))

    def prepare(unit):
        """Package one mesh group: batch_decode_args per section, stack,
        and upload (device_put is async; numpy goes straight to its shard)."""
        n, chunk_items = unit
        rebuilt = [batch_decode_args(pb, k) for _bi, pb in chunk_items]
        # pad payloads to one length so the stack is rectangular (zero
        # slack beyond a section's cap is never decoded)
        plen = max(a["payload"].size for a, _ in rebuilt)
        stacked = {
            name: np.stack([
                np.pad(a[name], (0, plen - a[name].size))
                if name == "payload" else a[name]
                for a, _ in rebuilt
            ])
            for name in rebuilt[0][0]
        }
        static = dict(rebuilt[0][1])
        for _a, s in rebuilt[1:]:
            for key in ("any_up", "any_cg", "pv_any_up", "pv_any_cg",
                        "any_pv_delta", "any_prev"):
                static[key] |= s[key]
        args = [
            jax.device_put(stacked[name], sharding)
            for name in ("payload", "plane_offs", "counts", "states",
                         "flags", "tables")
        ]
        cvals = jax.device_put(stacked["const_vals"], sharding)
        return n, static, args, cvals, chunk_items

    results_pv: dict[int, np.ndarray] = {}

    def finalize(pend):
        outs, chunk_items, n = pend
        imgs, ok = outs[0], outs[1]
        if not bool(np.asarray(ok).all()):
            raise ValueError("rANS stream integrity check failed")
        # pack_u8 byte stream [D, n*h, 2w] -> [D, n, h, w] u16
        imgs_np = np.asarray(imgs).view("<u2").reshape(len(chunk_items),
                                                       n, h, w)
        pv_np = np.asarray(outs[2]) if want_previews else None
        for di, (bi, _pb) in enumerate(chunk_items):
            results[bi] = imgs_np[di]
            if want_previews:
                results_pv[bi] = pv_np[di]

    pend = None
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(prepare, units[0]) if units else None
        for i in range(len(units)):
            n, static, args, cvals, chunk_items = nxt.result()
            nxt = (
                pool.submit(prepare, units[i + 1])
                if i + 1 < len(units) else None
            )
            step = sharded_fused_decode(
                mesh, chunk_len=k, b=n, h=h, w=w,
                decode_preview=want_previews, **static,
            )
            outs = step(*args, rdr._delta_high, rdr._delta_low, cvals)
            if pend is not None:
                finalize(pend)
            pend = (outs, chunk_items, n)
    if pend is not None:
        finalize(pend)
    for bi, pb, n in leftovers:
        imgs_l, pv_l = rdr._decode_parsed_batch(pb, n, want_previews)
        results[bi] = imgs_l
        if want_previews:
            results_pv[bi] = pv_l
    out = [results[bi] for bi in range(len(rdr._batches))]
    pv_out = (
        [results_pv[bi] for bi in range(len(rdr._batches))]
        if want_previews else []
    )
    if rdr.header.delta_is_frame0:
        out.insert(0, rdr.frame0()[None])
        if want_previews:
            from fpv_tpu.ops.preview import generate_preview

            pv_out.insert(
                0, np.asarray(generate_preview(rdr._delta_high[None]))
            )
    frames_all = (
        np.concatenate(out) if out else np.zeros((0, h, w), np.uint16)
    )
    if not want_previews:
        return frames_all
    pv_all = (
        np.concatenate(pv_out)
        if pv_out
        else np.zeros((0, h // 4, w // 4), np.uint8)
    )
    return frames_all, pv_all


def _per_device(a, n: int) -> list:
    """The ``n`` equal leading-axis pieces of ``a``, in device order.  A
    ``P('data')``-sharded array hands out its own shards, so taking a piece
    runs no program across devices: slicing the global array from several
    packaging threads at once hung four GPUs."""
    size = a.shape[0] // n
    shards = getattr(a, "addressable_shards", ())
    if len(shards) == n and all(s.data.shape[0] == size for s in shards):
        shards = sorted(shards, key=lambda s: s.index[0].start or 0)
        return [s.data for s in shards]
    return [a[d * size : (d + 1) * size] for d in range(n)]


def sharded_encode_file(
    frames: np.ndarray,
    mesh: Mesh,
    *,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    delta_frame: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
    _put_group=None,
    _put_delta=None,
    _pull=None,
    _pull_payload=None,
) -> bytes:
    """Encode [N, H, W] u16 frames into ONE FPVT file, batch sections
    data-parallel over ``mesh``: every group of mesh-size full batches runs
    as one sharded program (frames over ``P('data')``, shard-local tables
    and streams — the multi-chip generalization of the reference's
    frame-level worker pool, fusion_power_video.cc:1199-1230), then each
    device's output slice packages into its own batch section host-side.

    Every grouped section is bit-identical to fused_encode_batch on that
    frame slice, so files decode with FpvtReader or
    :func:`sharded_decode_file` alike; the whole file is byte-identical to
    the single-device encode_file_fpvt whenever ITS batches take the fused
    device path (device engine, batch pixels above narrow_max_syms — tested
    in tests/test_parallel.py).  Tail batches (fewer than a full mesh
    group) take the ordinary writer path and its encoder policy — with
    small frames that means narrow host-coded streams, where the
    single-device file would differ byte-wise (same decoded pixels).
    Device compute and host packaging pipeline two deep: group g's sections
    package (one thread per device slice) while group g+1 computes.
    ``timestamps``: optional per-frame i64 array (encode_file_fpvt
    semantics).  Expects a data-only mesh (space axis of size 1).

    ``_put_group`` / ``_put_delta`` / ``_pull`` are placement hooks for the
    multi-controller (multi-host) path: with a process-spanning mesh the
    inputs must become global arrays (each process contributing only its
    addressable slice) and the outputs must be gathered to every process
    before host packaging (parallel.distributed.distributed_encode_file
    passes make_array_from_callback / process_allgather here).  Defaults
    are the single-process placements."""
    from concurrent.futures import ThreadPoolExecutor

    from fpv_tpu.api.fpvt_codec import (
        file_encode_setup,
        package_encoded_batch,
    )
    from fpv_tpu.format import fpvt as _fpvt

    if _put_group is None:
        _put_group = lambda arr: shard_frames(arr, mesh)  # noqa: E731
    if _put_delta is None:
        _put_delta = lambda a: a  # noqa: E731
    if _pull is None:
        _pull = np.asarray
    if _pull_payload is None:
        # payloads stay device arrays locally (package_encoded_batch pulls
        # them bucketed); the multi-host path gathers them to numpy instead
        _pull_payload = lambda p: p  # noqa: E731
    ndev = mesh.shape["data"]
    bpb = frames_per_batch
    wri, header, body, ts_body = file_encode_setup(
        frames, shift, big_endian, bpb, chunk_log2, delta_frame, timestamps
    )
    h, w = wri.header.ysize, wri.header.xsize
    parts = [header]
    k = 1 << chunk_log2
    has_pv = (h // 4) * (w // 4) > 0
    n_full = (body.shape[0] // bpb) * bpb  # frames in full-size batches
    n_grouped = (n_full // (ndev * bpb)) * (ndev * bpb)
    if wri._narrow:
        # small file (file_encode_setup's narrow policy): its batches take
        # the narrow host path in encode_batch_bytes, which the sharded
        # fused program cannot reproduce — and a file this small gains
        # nothing from device parallelism.  Route every batch through the
        # single-device writer so the output stays byte-identical.
        n_grouped = 0
    step = (
        sharded_fused_encode(
            mesh, shift, big_endian, k, low_coding=wri._low_coding,
            allow_prev=wri._allow_prev,
        )
        if n_grouped
        else None
    )

    def package_group(dpool, outs, base: int) -> list[bytes]:
        """Pull + package one sharded output into ndev sections (in device
        order; ``base`` = the group's first frame index in ``body``);
        slices are independent so they package concurrently on ``dpool``
        (one pool reused across all groups)."""
        small_g, st_g = _pull(outs[0]), _pull(outs[1])
        pays = [_per_device(_pull_payload(p), ndev) for p in outs[2:]]
        L = small_g.size // ndev
        SL = st_g.size // ndev

        def one(d: int) -> bytes:
            flags, (hs, ls, pvs) = package_encoded_batch(
                small_g[d * L : (d + 1) * L],
                st_g[d * SL : (d + 1) * SL],
                *(p[d] for p in pays),
                b=bpb, h=h, w=w, chunk_len=k, low_coding=wri._low_coding,
                # CODING_RAW recovery context: the same decision (exact
                # serialized sizes from counts) and the same integer-exact
                # residual recompute as the single-device writer, so the
                # sharded file stays byte-identical to it
                raw_ctx=dict(
                    imgs=body[base + d * bpb : base + (d + 1) * bpb],
                    delta_high=wri._delta_high,
                    delta_low=wri._delta_low,
                    shift=shift,
                    big_endian=big_endian,
                ),
            )
            ts = (
                np.full(bpb, -1, np.int64)
                if ts_body is None
                else ts_body[base + d * bpb : base + (d + 1) * bpb]
            )
            return _fpvt.serialize_batch_section(
                flags, ts, hs, ls, pvs if has_pv else None,
            )

        return list(dpool.map(one, range(ndev)))

    # two-deep pipeline: dispatch group g+1 (async), then package group g's
    # outputs while the devices compute
    pend = None
    with ThreadPoolExecutor(max_workers=min(ndev, 8)) as dpool:
        for s in range(0, n_grouped, ndev * bpb):
            outs = step(
                _put_group(body[s : s + ndev * bpb]),
                _put_delta(wri._delta_high),
                _put_delta(wri._delta_low),
            )
            if pend is not None:
                for sec in package_group(dpool, *pend):
                    parts.append(wri.add_batch(sec, bpb))
            pend = (outs, s)
        if pend is not None:
            for sec in package_group(dpool, *pend):
                parts.append(wri.add_batch(sec, bpb))
    for s in range(n_grouped, body.shape[0], bpb):
        nb = min(bpb, body.shape[0] - s)
        parts.append(wri.add_batch(
            wri.encode_batch_bytes(
                body[s : s + nb],
                None if ts_body is None else ts_body[s : s + nb],
            ),
            nb,
        ))
    parts.append(wri.finish())
    return b"".join(parts)


def multichip_dryrun(n_devices: int, h: int = 32, w: int = 32) -> None:
    """Compile + execute the FULL codec (model step, device tables, rANS
    encode/decode kernels, inverse predictors) sharded over an
    ``n_devices`` mesh, and verify the roundtrip.

    Runs on ``n_devices`` GPUs, or on a virtual CPU mesh
    (``--xla_force_host_platform_device_count=N``) with the kernels in the
    Pallas interpreter (FPV_TPU_RANS_ENGINE=interpret).  With fewer devices
    than asked it raises."""
    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"multichip_dryrun({n_devices}) needs {n_devices} devices; "
            f"this process has {len(jax.devices())} ({jax.default_backend()})"
        )
    mesh = make_mesh(n_devices)
    step = sharded_codec_roundtrip(mesh, chunk_len=32)
    b = 2 * n_devices  # 2 frames per device
    frames = _test_frames(b, h, w)
    delta = frames[0]
    dh = (delta >> 8).astype(np.uint8)
    dl = (delta & 0xFF).astype(np.uint8)
    imgs_s = shard_frames(frames, mesh)
    out, ok = step(imgs_s, jnp.asarray(dh), jnp.asarray(dl))
    jax.block_until_ready(out)
    if not bool(ok):
        raise AssertionError("sharded full-codec roundtrip failed")
    if not np.array_equal(np.asarray(out), frames):
        raise AssertionError("sharded full-codec output mismatch")
    _dryrun_production_config(mesh, n_devices)
    _dryrun_production_decode(mesh, n_devices)


def _dryrun_production_config(mesh: Mesh, n_devices: int) -> None:
    """Compile + execute sharded_fused_encode in the SHIPPING configuration:
    context-coded low plane (CODING_CTX16) with chunk_len 4096 (segmented
    state carry, rans_layout SEG_LEN) — the FpvtWriter default for
    shift >= 4 — and verify bit-exactness against per-device
    fused_encode_batch runs."""
    from fpv_tpu.api.fpvt_codec import fused_encode_batch
    from fpv_tpu.ops.rans_layout import CODING_CTX16

    chunk_len = 4096
    shift = 4
    # chunk_len 4096 makes the kernels run all 8 segments with
    # cross-segment state carry (the carry executes regardless of lens;
    # interpret mode iterates every step, so small frames keep the dryrun
    # bounded — content-bearing multi-segment coverage lives in
    # tests/test_rans.py's segmented-chunk tests)
    h, w = 96, 128  # hw = 12288 px; 2 frames/device
    b = 2 * n_devices
    frames = (_test_frames(b, h, w) >> 4).astype(np.uint16)  # 12-bit
    delta = frames[0]
    dh = (((delta.astype(np.uint32) << shift) >> 8) & 0xFF).astype(np.uint8)
    dl = ((delta.astype(np.uint32) << shift) & 0xFF).astype(np.uint8)
    step = sharded_fused_encode(
        mesh, shift=shift, chunk_len=chunk_len, low_coding=CODING_CTX16,
        allow_prev=True,
    )
    imgs_s = shard_frames(frames, mesh)
    outs = step(imgs_s, jnp.asarray(dh), jnp.asarray(dl))
    jax.block_until_ready(outs)
    # bit-exactness vs single-device runs of EVERY device's slice (a
    # sharding bug that corrupts only non-zero shards must not pass)
    per = b // n_devices
    for d in range(n_devices):
        ref = fused_encode_batch(
            jnp.asarray(frames[d * per : (d + 1) * per]),
            jnp.asarray(dh), jnp.asarray(dl),
            shift, False, chunk_len, True, CODING_CTX16, True,
        )
        for got, want in zip(outs, ref):
            want = np.asarray(want)
            L = np.asarray(got).shape[0] // n_devices
            g = np.asarray(got)[d * L : d * L + want.shape[0]]
            if not np.array_equal(g, want):
                raise AssertionError(
                    f"sharded production-config encode not bit-exact "
                    f"(device {d})"
                )


def _dryrun_production_decode(mesh: Mesh, n_devices: int) -> None:
    """Compile + execute the sharded production-config DECODE: one FPVT file
    whose sections carry the shipping configuration (ctx16 low plane,
    chunk_len 4096 device-geometry streams), one section per device, decoded
    through sharded_decode_file and verified pixel-exact."""
    from fpv_tpu.api.fpvt_codec import FpvtWriter
    from fpv_tpu.format import fpvt as _fpvt

    h, w = 96, 128
    shift = 4
    bpb = 2
    rng = np.random.default_rng(1)
    frames = rng.integers(
        0, 1 << 12, size=(n_devices * bpb, h, w), dtype=np.uint16
    )
    wtr = FpvtWriter(w, h, shift=shift, frames_per_batch=bpb)
    parts = [wtr.init(frames[0])]
    for i in range(n_devices):
        sub = np.asarray(frames[i * bpb : (i + 1) * bpb], np.uint16)
        # _encode_batch_fused directly: the public encode_batch routes small
        # batches to narrow host-coded streams, but this dryrun must produce
        # device-geometry sections for the sharded fused decode
        flags, (hs, ls, pvs) = wtr._encode_batch_fused(wtr._put(sub), bpb)
        sec = _fpvt.serialize_batch_section(
            flags, np.full(bpb, -1, np.int64), hs, ls, pvs
        )
        parts.append(wtr.add_batch(sec, bpb))
    parts.append(wtr.finish())
    out = sharded_decode_file(b"".join(parts), mesh)
    want = (frames.astype(np.uint32) << shift).astype(np.uint16)
    if not np.array_equal(out, want):
        raise AssertionError("sharded production-config decode mismatch")


def _test_frames(b: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 16, size=(b, h, w), dtype=np.uint16)
