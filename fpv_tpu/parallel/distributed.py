"""Multi-process stream and batch sharding.

The reference is single-process: its only scaling axis is the in-process
worker pool (fusion_power_video.cc:1199-1230).  The device equivalent for
multi-process deployments is pure data parallelism over a process-spanning
``jax.sharding.Mesh``: frames/batches shard over every device of every
process, the fused codec programs run SPMD (no cross-replica dependency
exists in the codec itself — streams and batch sections are independent),
and only the host-side gather of compressed bytes / decoded pixels crosses
processes (``jax.experimental.multihost_utils`` collectives).

Multi-controller model: every process runs the same program on the same
file-level inputs and returns the same result; each process touches only
its addressable shard of the device work.

Tested by spawning two CPU processes with four virtual devices each
(tests/test_distributed.py).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
) -> None:
    """Join this process to a multi-host JAX cluster.

    Thin wrapper over ``jax.distributed.initialize`` so callers configure
    the cluster through fpv_tpu.  The coordinator address (e.g.
    ``localhost:<port>``), process count and process id are always given
    explicitly.  Must run before any JAX computation in the process."""
    kwargs = {}
    if local_device_count is not None:
        kwargs["local_device_ids"] = list(range(local_device_count))
    jax.distributed.initialize(
        coordinator_address, num_processes=num_processes,
        process_id=process_id, **kwargs,
    )


def global_data_mesh(space: int = 1) -> Mesh:
    """(data, space) mesh over ALL devices of ALL processes."""
    devs = jax.devices()
    data = len(devs) // space
    grid = np.array(devs[: data * space]).reshape(data, space)
    return Mesh(grid, axis_names=("data", "space"))


def _put_group_fn(mesh: Mesh):
    """[B, H, W] numpy -> global array sharded P('data'); each process
    materializes only its addressable slices (ingest sharding: a real
    multi-host pipeline feeds each host only its cameras' frames)."""
    sh = NamedSharding(mesh, P("data", None, None))

    def put(arr: np.ndarray):
        return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])

    return put


def _put_replicated_fn(mesh: Mesh):
    """Host/device array -> fully-replicated global array (delta planes)."""
    sh = NamedSharding(mesh, P(None, None))

    def put(a):
        a_np = np.asarray(a)
        return jax.make_array_from_callback(
            a_np.shape, sh, lambda idx: a_np[idx]
        )

    return put


def _allgather(x) -> np.ndarray:
    """Gather a P('data')-sharded global array to full numpy on every
    process (the cross-process hop; host packaging needs the whole output)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def distributed_encode_file(
    frames: np.ndarray,
    *,
    mesh: Mesh | None = None,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    delta_frame: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
) -> bytes:
    """Encode one FPVT file with batch groups running as process-spanning
    sharded programs over every chip of every host.

    Semantics and byte-output are identical to
    :func:`fpv_tpu.parallel.mesh.sharded_encode_file` on a same-size
    single-process mesh (and therefore byte-identical to the single-device
    encode_file_fpvt in the fused-path regime) — the only differences are
    placement: inputs become global arrays built per-process from local
    slices, and each group's compressed streams allgather across processes so
    every process assembles the identical complete file."""
    from fpv_tpu.parallel import mesh as pmesh

    if mesh is None:
        mesh = global_data_mesh()
    return pmesh.sharded_encode_file(
        frames, mesh,
        shift=shift, big_endian=big_endian,
        frames_per_batch=frames_per_batch, chunk_log2=chunk_log2,
        delta_frame=delta_frame, timestamps=timestamps,
        _put_group=_put_group_fn(mesh),
        _put_delta=_put_replicated_fn(mesh),
        _pull=_allgather,
        _pull_payload=_allgather,
    )


def distributed_decode_file(data: bytes) -> np.ndarray:
    """Decode one FPVT file with batches sharded round-robin over
    processes; every process returns the full [N, H, W] uint16 result.

    Batches are independent given the delta section, so this is pure data
    parallelism: each process decodes its batches on its own local
    devices (the existing single-process fused paths), and only the final
    pixel gather crosses processes.  This is the multi-host generalization of
    the serving hubs' per-device stream pinning."""
    from jax.experimental import multihost_utils

    from fpv_tpu.api.fpvt_codec import FpvtReader

    pid, nproc = jax.process_index(), jax.process_count()
    r = FpvtReader(data)
    nb = r.num_batches
    h, w = r.header.ysize, r.header.xsize
    counts = [n for (_off, n) in r._batches]
    outs: list[np.ndarray | None] = [None] * nb
    if nproc <= 1:
        for i in range(nb):
            outs[i] = r.decode_batch(i)
    else:
        n_max = -(-nb // nproc) if nb else 0
        bpb = max(counts, default=0)
        buf = np.zeros((max(n_max, 1), bpb, h, w), np.uint16)
        for j, i in enumerate(range(pid, nb, nproc)):
            out = r.decode_batch(i)
            buf[j, : out.shape[0]] = out
        # [nproc, n_max, bpb, h, w]: one cross-process gather for all pixels
        g = np.asarray(multihost_utils.process_allgather(buf))
        for i in range(nb):
            outs[i] = g[i % nproc, i // nproc, : counts[i]]
    if r.header.delta_is_frame0:
        outs.insert(0, r.frame0()[None])
    if not outs:
        return np.zeros((0, h, w), np.uint16)
    return np.concatenate(outs)
