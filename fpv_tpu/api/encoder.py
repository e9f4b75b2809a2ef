"""Session-layer encoder with the reference's Encoder semantics.

Mirrors ``fpvc::Encoder`` (fusion_power_video.h:175-255): ``init`` writes the
header + compressed delta-frame chunk, ``compress_frame`` queues one frame
and invokes its callback *in submission order* when the compressed chunk is
ready, ``finish`` drains everything and writes the frame-index footer.

Differences from the reference are a deliberate device-first redesign:

* the worker pool compresses entropy streams concurrently but emission
  order is enforced by task id exactly like the reference's cv_out ordering
  barrier (fusion_power_video.cc:1199-1230);
* backpressure matches ``MaxQueued() == threads + (threads+1)/2``
  (fusion_power_video.cc:1171-1177).
"""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np

from fpv_tpu.api import frame as frame_ops
from fpv_tpu.api.frame import FramePlanes
from fpv_tpu.format import container

Callback = Callable[[bytes, object], None]


def _native_compress_frame():
    """fpv_native.compress_frame if the extension is built, else None."""
    import os

    if os.environ.get("FPV_TPU_COMPAT_NATIVE") == "0":
        return None
    from fpv_tpu.entropy.brotli import _native

    return getattr(_native, "compress_frame", None)


def _compress_frame_bytes(
    img: np.ndarray,
    xsize: int,
    ysize: int,
    shift: int,
    big_endian: bool,
    delta: FramePlanes | None,
) -> bytes:
    """One frame through the full compat pipeline -> frame chunk bytes.

    Fast path: the whole pipeline (split, preview, heuristics, prediction,
    brotli) runs in one GIL-released native call (native/fpv_native.cc);
    the numpy stage functions below remain the tested oracle
    (FPV_TPU_COMPAT_NATIVE=0 forces them)."""
    native = _native_compress_frame()
    if native is not None:
        img = np.ascontiguousarray(img, dtype=np.uint16).reshape(ysize, xsize)
        dh = delta.high if delta is not None else None
        dl = delta.low if delta is not None else None
        _flags, image_bs, preview_bs = native(
            img, xsize, ysize, shift, big_endian, dh, dl,
            delta is not None, True,
        )
        return container.serialize_frame_chunk(preview_bs, image_bs)
    planes = frame_ops.split_planes(
        np.asarray(img, dtype=np.uint16).reshape(ysize, xsize), shift, big_endian
    )
    predicted = frame_ops.predict(planes, delta, make_preview=True)
    image_bs = container.serialize_image(predicted)
    preview_bs = container.serialize_preview_image(
        predicted.preview, predicted.flags
    )
    return container.serialize_frame_chunk(preview_bs, image_bs)


def _compress_planes_bytes(
    high: np.ndarray,
    low: np.ndarray | None,
    delta: FramePlanes | None,
) -> bytes:
    """Plane-adopting twin of :func:`_compress_frame_bytes`: pre-split byte
    planes enter the pipeline directly (the reference's plane-adopting
    Frame ctor, fusion_power_video.cc:467-489) — no combine/split round
    trip, bitstream byte-identical to image ingest."""
    fn = None
    if _native_compress_frame() is not None:
        from fpv_tpu.entropy.brotli import _native

        fn = getattr(_native, "compress_frame_planes", None)
    if fn is not None:
        dh = delta.high if delta is not None else None
        dl = delta.low if delta is not None else None
        _flags, image_bs, preview_bs = fn(
            high, low, high.shape[1], high.shape[0], dh, dl,
            delta is not None, True,
        )
        return container.serialize_frame_chunk(preview_bs, image_bs)
    planes = frame_ops.adopt_planes(high, low)
    predicted = frame_ops.predict(planes, delta, make_preview=True)
    image_bs = container.serialize_image(predicted)
    preview_bs = container.serialize_preview_image(
        predicted.preview, predicted.flags
    )
    return container.serialize_frame_chunk(preview_bs, image_bs)


class Encoder:
    """Streaming encoder producing reference-format (FPV1) files.

    Parameters mirror the reference ctor (fusion_power_video.h:179):
    ``num_threads`` sizes the worker pool (0 = synchronous), ``shift`` is the
    left-align shift for sub-16-bit data, ``big_endian`` the raw input
    endianness.
    """

    def __init__(
        self,
        num_threads: int = 8,
        shift: int = 0,
        big_endian: bool = False,
    ) -> None:
        self._num_threads = int(num_threads)
        self._shift = int(shift)
        self._big_endian = bool(big_endian)
        self._pool = (
            ThreadPoolExecutor(max_workers=self._num_threads)
            if self._num_threads
            else None
        )
        self._pending: collections.deque[tuple[Future | bytes, Callback, object]] = (
            collections.deque()
        )
        self._delta: FramePlanes | None = None
        self._xsize = 0
        self._ysize = 0
        self._frame_offsets: list[int] = []
        self._bytes_written = 0
        self._finished = False

    def _coerce(self, img: np.ndarray) -> np.ndarray:
        """Accept uint8 frames (Frame's 8-bit ctor,
        fusion_power_video.cc:453-465): widening to uint16 is
        value-preserving and the shift==8 LE split stores exactly the
        sample bytes as the single high plane, so the bitstream matches
        the reference ctor's byte-for-byte."""
        img = np.asarray(img)
        if img.dtype == np.uint8:
            from fpv_tpu.ops.planes import validate_u8_config

            validate_u8_config(self._shift, self._big_endian)
            img = img.astype(np.uint16)
        return np.ascontiguousarray(img, dtype=np.uint16)

    def max_queued(self) -> int:
        """Max frames in flight (fusion_power_video.cc:1171-1177)."""
        if not self._num_threads:
            return 1
        return self._num_threads + (self._num_threads + 1) // 2

    def init(
        self,
        delta_frame: np.ndarray,
        xsize: int,
        ysize: int,
        callback: Callback,
        payload: object = None,
    ) -> None:
        """Write header + delta-frame chunk (Encoder::Init,
        fusion_power_video.cc:1086-1106)."""
        self._xsize, self._ysize = int(xsize), int(ysize)
        img = self._coerce(delta_frame).reshape(ysize, xsize)
        self._delta = frame_ops.split_planes(img, self._shift, self._big_endian)
        # Compress a copy of the delta frame: preview generated but dropped
        # by OutputCore; no delta prediction; CG optional.
        native = _native_compress_frame()
        if native is not None:
            _flags, image_bs, _pv = native(
                img, self._xsize, self._ysize, self._shift,
                self._big_endian, None, None, False, False,
            )
        else:
            predicted = frame_ops.predict(self._delta, None, make_preview=False)
            # The reference *does* generate and CG-transform a preview here
            # via Predict, but OutputCore never emits it, so skipping
            # generation is output-equivalent.  The CG decision only looks
            # at the high plane.
            image_bs = container.serialize_image(predicted)
        out = (
            container.serialize_header(self._xsize, self._ysize)
            + container.serialize_delta_chunk(image_bs)
        )
        self._bytes_written = len(out)
        callback(out, payload)

    def init_planes(
        self,
        high: np.ndarray,
        low: np.ndarray | None,
        callback: Callback,
        payload: object = None,
    ) -> None:
        """Plane-adopting twin of :meth:`init`: the delta frame enters as
        pre-split byte planes (fusion_power_video.cc:467-489)."""
        self._ysize, self._xsize = np.asarray(high).shape
        high, low = self._coerce_planes(high, low)
        self._delta = frame_ops.adopt_planes(high, low)
        fn = None
        if _native_compress_frame() is not None:
            from fpv_tpu.entropy.brotli import _native

            fn = getattr(_native, "compress_frame_planes", None)
        if fn is not None:
            _flags, image_bs, _pv = fn(
                high, low, self._xsize, self._ysize, None, None, False, False
            )
        else:
            predicted = frame_ops.predict(
                self._delta, None, make_preview=False
            )
            image_bs = container.serialize_image(predicted)
        out = (
            container.serialize_header(self._xsize, self._ysize)
            + container.serialize_delta_chunk(image_bs)
        )
        self._bytes_written = len(out)
        callback(out, payload)

    def compress_frame(
        self, img: np.ndarray, callback: Callback, payload: object = None
    ) -> None:
        """Queue one frame; callbacks fire in submission order.

        Applies backpressure so at most ``max_queued()`` frames are in
        flight, mirroring the cv_main wait (fusion_power_video.cc:1150-1156).
        ``img`` is copied at submission, so the caller may reuse its buffer
        immediately (a relaxation of the reference's buffer-rotation
        contract, encode.cc:67-74).
        """
        if self._delta is None:
            raise RuntimeError("init() must be called first")
        img = np.array(self._coerce(img), copy=True)
        args = (
            img,
            self._xsize,
            self._ysize,
            self._shift,
            self._big_endian,
            self._delta,
        )
        if self._pool is None:
            self._pending.append((_compress_frame_bytes(*args), callback, payload))
        else:
            self._pending.append(
                (self._pool.submit(_compress_frame_bytes, *args), callback, payload)
            )
        # Emit every already-completed head-of-queue task; then apply
        # backpressure by blocking on the head until under the limit.
        self._drain(block=False)
        while len(self._pending) >= self.max_queued():
            self._drain_one()

    def _coerce_planes(
        self, high: np.ndarray, low: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray | None]:
        high = np.ascontiguousarray(high, dtype=np.uint8)
        if high.shape != (self._ysize, self._xsize):
            raise ValueError("high plane must be [ysize, xsize] uint8")
        if low is not None:
            low = np.ascontiguousarray(low, dtype=np.uint8)
            if low.shape != high.shape:
                raise ValueError("low plane shape must match high plane")
        return high, low

    def compress_frame_planes(
        self,
        high: np.ndarray,
        low: np.ndarray | None,
        callback: Callback,
        payload: object = None,
    ) -> None:
        """Queue one frame given as pre-split byte planes.

        The plane-adopting ingest path (reference Frame plane ctor,
        fusion_power_video.cc:467-489): a source that already produces
        high/low byte planes skips the uint16 combine + re-split round
        trip entirely.  ``low=None`` (or an all-zero low) emits a
        NO_LOW_BYTES frame.  Output bytes are identical to
        :meth:`compress_frame` on the combined image; ordering and
        backpressure semantics are shared."""
        if self._delta is None:
            raise RuntimeError("init() must be called first")
        high, low = self._coerce_planes(high, low)
        high = np.array(high, copy=True)
        low = np.array(low, copy=True) if low is not None else None
        args = (high, low, self._delta)
        if self._pool is None:
            self._pending.append(
                (_compress_planes_bytes(*args), callback, payload)
            )
        else:
            self._pending.append(
                (self._pool.submit(_compress_planes_bytes, *args),
                 callback, payload)
            )
        self._drain(block=False)
        while len(self._pending) >= self.max_queued():
            self._drain_one()

    def _drain_one(self) -> None:
        task, callback, payload = self._pending.popleft()
        data = task.result() if isinstance(task, Future) else task
        self._frame_offsets.append(self._bytes_written)
        self._bytes_written += len(data)
        callback(data, payload)

    def _drain(self, block: bool) -> None:
        while self._pending:
            head = self._pending[0][0]
            if not block and isinstance(head, Future) and not head.done():
                return
            self._drain_one()

    def finish(self, callback: Callback, payload: object = None) -> None:
        """Drain all queued frames and emit the footer (Encoder::Finish)."""
        if self._finished:
            return
        self._finished = True
        self._drain(block=True)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        callback(container.serialize_footer(self._frame_offsets), payload)


def encode_file(
    frames: np.ndarray,
    shift: int = 0,
    big_endian: bool = False,
    num_threads: int = 4,
    delta_frame: np.ndarray | None = None,
) -> bytes:
    """Convenience one-shot encode of [N, H, W] uint16 frames -> FPV1 bytes.

    uint8 frames are accepted directly (shift auto-selects 8, the
    reference's 8-bit Frame ctor layout)."""
    from fpv_tpu.ops.planes import resolve_u8_shift

    frames = np.asarray(frames)
    shift = resolve_u8_shift(frames.dtype, shift, big_endian)
    frames = np.asarray(frames, dtype=np.uint16)
    if frames.ndim != 3:
        raise ValueError("frames must be [N, H, W]")
    if delta_frame is None:
        delta_frame = frames[0]
    n, ysize, xsize = frames.shape
    chunks: list[bytes] = []

    def cb(data: bytes, _payload: object) -> None:
        chunks.append(data)

    enc = Encoder(num_threads=num_threads, shift=shift, big_endian=big_endian)
    enc.init(delta_frame, xsize, ysize, cb)
    for i in range(n):
        enc.compress_frame(frames[i], cb)
    enc.finish(cb)
    return b"".join(chunks)
