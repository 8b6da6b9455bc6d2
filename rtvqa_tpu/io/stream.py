"""Streaming frame ingestion: bounded-memory batches + prefetch overlap.

``decode_sampled`` (io.video) materializes a whole clip — fine for sampled
complexity analysis, heavy for every-frame 1080p quality metrics on long
clips. This module wraps the native streaming API
(``rtvqa_stream_open/next/close``) as a Python iterator of fixed-size YUV420
batches, plus a one-deep background-thread prefetcher so host decode overlaps
device compute (the host⇄device double-buffering called for by SURVEY.md §1
L2 / §7 step 2; the natural pipeline-parallelism analog of §2.3).
"""

from __future__ import annotations

import ctypes
import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from rtvqa_tpu.io import video as vio


@dataclasses.dataclass
class FrameBatch:
    y: np.ndarray            # (B, H, W) uint8
    u: np.ndarray            # (B, H/2, W/2) uint8
    v: np.ndarray            # (B, H/2, W/2) uint8
    timestamps_ms: np.ndarray  # (B,) float64
    start_index: int         # global index of the first sampled frame


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    width: int
    height: int
    chroma_w: int
    chroma_h: int
    bit_rate: int
    avg_fps: float


class VideoStream:
    """Iterator over sampled-frame batches of one clip (bounded memory)."""

    def __init__(self, path: str, frame_interval: int = 1, batch: int = 32):
        vio.validate_video_path(path)
        self._lib = vio._load()
        self._lib.rtvqa_stream_open.restype = ctypes.c_void_p
        self._lib.rtvqa_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self._lib.rtvqa_stream_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        self._lib.rtvqa_stream_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
        self._lib.rtvqa_stream_close.argtypes = [ctypes.c_void_p]
        self._handle = self._lib.rtvqa_stream_open(path.encode(), int(frame_interval))
        if not self._handle:
            raise vio.ClipError(f"stream open failed: {vio._err(self._lib)}")
        raw = (ctypes.c_int64 * 6)()
        self._lib.rtvqa_stream_info(self._handle, raw)
        w, h, cw, ch, bitrate, fps_milli = (int(x) for x in raw)
        self.info = StreamInfo(w, h, cw, ch, bitrate, fps_milli / 1000.0)
        self.batch = batch
        self._consumed = 0

    def __iter__(self) -> Iterator[FrameBatch]:
        return self

    def __next__(self) -> FrameBatch:
        if self._handle is None:
            raise StopIteration
        i = self.info
        y = np.empty((self.batch, i.height, i.width), np.uint8)
        u = np.empty((self.batch, i.chroma_h, i.chroma_w), np.uint8)
        v = np.empty((self.batch, i.chroma_h, i.chroma_w), np.uint8)
        ts = np.empty((self.batch,), np.float64)
        n = self._lib.rtvqa_stream_next(
            self._handle,
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.batch,
        )
        if n < 0:
            self.close()
            raise vio.ClipError(f"stream decode failed: {vio._err(self._lib)}")
        if n == 0:
            self.close()
            raise StopIteration
        start = self._consumed
        self._consumed += n
        return FrameBatch(y[:n], u[:n], v[:n], ts[:n], start)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.rtvqa_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_SENTINEL = object()


def prefetch(iterator: Iterator, depth: int = 1) -> Iterator:
    """Run ``iterator`` in a background thread, ``depth`` items ahead.

    With depth=1 this is classic double buffering: the producer decodes batch
    k+1 while the consumer computes on batch k.

    If the consumer abandons the generator early (``break``, exception, or
    garbage collection — e.g. the lockstep break in
    ``full_reference.analyze_full_reference``), the producer is cancelled and
    the underlying iterator's ``close()`` is called, so decoder contexts are
    released immediately instead of leaking until process exit.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    cancelled = threading.Event()

    def worker():
        try:
            for item in iterator:
                # Bounded put so a vanished consumer can't block us forever;
                # re-check the cancellation flag between attempts.
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            while True:  # sentinel must land even if the queue is full
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if cancelled.is_set():
                        break

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        cancelled.set()
        # Drain one slot so a producer blocked in q.put can observe the flag.
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)


def stream_batches(
    path: str, frame_interval: int = 1, batch: int = 32, prefetch_depth: int = 1
) -> Iterator[FrameBatch]:
    """Prefetched sampled-frame batches of one clip."""
    return prefetch(VideoStream(path, frame_interval, batch), depth=prefetch_depth)


@dataclasses.dataclass
class StagedFrameBatch:
    """A decoded batch plus (for full chunks) its planes staged on the device.

    Passing fresh numpy arrays to a jitted program uploads them inside the
    dispatch, once per program that consumes them. Staging explicitly in the
    prefetch worker thread overlaps the transfer with device compute and
    uploads each plane exactly once per chunk regardless of how many
    programs consume it.

    ``y/u/v`` are committed device arrays for full ``chunk``-sized batches and
    ``None`` for ragged tails (the consumer host-pads those — once per clip).
    ``host`` always carries the decoded numpy planes (complexity sampling and
    ragged handling read them).
    """

    host: FrameBatch
    y: object = None
    u: object = None
    v: object = None


def stage_to_device(
    iterator: Iterator[FrameBatch], chunk: Optional[int]
) -> Iterator[StagedFrameBatch]:
    """Wrap a FrameBatch iterator, staging full chunks into device memory.

    Meant to run inside ``prefetch`` so the transfer happens on the producer
    thread: ``prefetch(stage_to_device(VideoStream(...), chunk))``.
    ``chunk=None`` disables staging (batches pass through host-only — the
    sharded runners place data across the mesh themselves).
    """
    import jax

    try:
        for fb in iterator:
            if chunk is not None and fb.y.shape[0] == chunk:
                planes = (
                    jax.device_put(fb.y), jax.device_put(fb.u), jax.device_put(fb.v)
                )
                # Finish the transfer HERE, on the producer thread, so the
                # consumer's dispatch never waits on it.
                jax.block_until_ready(planes)
                yield StagedFrameBatch(fb, *planes)
            else:
                yield StagedFrameBatch(fb)
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()
