"""Streaming complexity analysis for long clips (bounded host + device memory).

`calculate_average_scene_complexity` materializes all sampled frames; at
frame_interval=1 on an hour-long 1080p clip that is tens of GB. This driver
streams sampled-frame batches (prefetched native decode), runs ONE jitted
program per chunk that produces the per-frame metric values packed as one
array (a single device→host fetch per chunk), carries the 1-frame
temporal halo across chunk boundaries on the host, and finishes with the
exponential smoothing + means over the accumulated scalar series (N floats —
negligible host work, numerically identical to the fused path; verified in
tests).

Per-global-frame value semantics are those of `parallel.sharding`
(`_per_frame_values`): slot g holds metrics of sampled frame g vs g-1; the
reference's series are re-indexings of these slots.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.io.stream import VideoStream, prefetch
from rtvqa_tpu.metrics.complexity import ComplexityResult, METRIC_ORDER
from rtvqa_tpu.parallel.sharding import _per_frame_values_series

# Packed row order for the seven device-computed values (framerate variation
# is computed on the host from timestamps).
VALUE_KEYS = ("motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct")


def _chunk_values_body(
    y, u, v, tail_y, tail_u, tail_v, *,
    resize_h, resize_w, block=16, radius=8, edge_low=100.0, edge_high=200.0,
    motion_search="pyramid",
):
    """Per-frame complexity values for one chunk; the previous-frame operand
    is the carried 1-frame tail PREPENDED on device (uploading a host-built
    prev array would double the chunk's host→device bytes), and the extended
    series runs through the
    series-form kernel: gray conversion, resize, and the pyramid downsample
    happen once over N+1 frames instead of twice over N."""
    y_ext = jnp.concatenate([tail_y[None], y], axis=0)
    u_ext = jnp.concatenate([tail_u[None], u], axis=0)
    v_ext = jnp.concatenate([tail_v[None], v], axis=0)
    vals = _per_frame_values_series(
        y_ext, u_ext, v_ext,
        resize_h=resize_h, resize_w=resize_w, block=block, radius=radius,
        edge_low=edge_low, edge_high=edge_high, motion_search=motion_search,
    )
    return jnp.stack([vals[k].astype(jnp.float32) for k in VALUE_KEYS])


#: Jitted per-chunk dispatch (the plain body stays importable so the merged
#: quality+complexity chunk program in ``metrics.full_reference`` can trace it
#: inside ONE fused XLA program — one dispatch + one fetch per chunk).
_chunk_values = functools.partial(
    jax.jit,
    static_argnames=("resize_h", "resize_w", "block", "radius", "edge_low",
                     "edge_high", "motion_search"),
)(_chunk_values_body)


def _ewm_mean_host(series: np.ndarray, alpha: float) -> float:
    """pandas-equivalent ewm(adjust=True).mean() then mean — on N scalars.

    adjust=True: y_t = sum_{i<=t} (1-a)^(t-i) x_i / sum_{i<=t} (1-a)^(t-i).
    The numerator recursion s_t = (1-a) s_{t-1} + x_t runs as one
    ``scipy.signal.lfilter`` call (identical double-precision recursion,
    vectorized); the denominator has the closed form (1 - (1-a)^(t+1)) / a.
    """
    if series.size == 0:
        return 0.0
    from scipy.signal import lfilter

    q = 1.0 - alpha  # alpha in (0, 1] per config validation, so q in [0, 1)
    x = np.asarray(series, np.float64)
    s = lfilter([1.0], [1.0, -q], x)
    t = np.arange(x.size, dtype=np.float64)
    c = (1.0 - q ** (t + 1.0)) / (1.0 - q) if q else np.ones_like(t)
    return float(np.mean(s / c))


class ComplexityAccumulator:
    """Incremental streaming complexity: feed sampled-frame batches, get the
    reference 8-tuple at the end.

    Extracted from the streaming driver so other single-decode-pass engines
    (the combined quality+complexity engine in ``metrics.full_reference``) can
    tap sampled frames out of an existing decode loop instead of paying a
    second decode of the same stream (the reference decodes three times —
    SURVEY.md §2.4(3); this brings the whole pipeline to the two-pass minimum:
    each of ref/dis decoded exactly once).

    Chunking, the 1-frame temporal carry, ragged-tail padding and the EWM
    pooling are byte-identical to the standalone streaming driver (equivalence
    is tested).
    """

    def __init__(
        self,
        resize_width: int,
        resize_height: int,
        smoothing_factor: float = 0.8,
        chunk: int = 32,
        block: int = 16,
        radius: int = 8,
        motion_search: str = "pyramid",
    ):
        self.resize_width = resize_width
        self.resize_height = resize_height
        self.alpha = float(smoothing_factor)
        self.chunk = chunk
        self.block = block
        self.radius = radius
        self.motion_search = motion_search
        self.values: dict[str, list[np.ndarray]] = {k: [] for k in VALUE_KEYS}
        self.timestamps: list[np.ndarray] = []
        self.n_total = 0
        self._prev_tail: Optional[tuple] = None
        self._buf: list[tuple] = []  # pending (y, u, v) batches
        self._buf_ts: list[np.ndarray] = []
        self._buf_n = 0

    def add(self, y: np.ndarray, u: np.ndarray, v: np.ndarray, ts: np.ndarray) -> None:
        """Feed a batch of *sampled* frames ((n,H,W), (n,h,w), (n,h,w), (n,))."""
        if y.shape[0] == 0:
            return
        self._buf.append((y, u, v))
        self._buf_ts.append(np.asarray(ts, np.float64))
        self._buf_n += y.shape[0]
        if self._buf_n >= self.chunk:
            # Concatenate ONCE, then flush chunk-sized views (re-concatenating
            # the pending buffer per drained chunk is O(buffer^2) in copies
            # for large add() batches).
            self._consolidate()
            ys, us, vs = self._buf[0]
            ts_all = self._buf_ts[0]
            off = 0
            while self._buf_n - off >= self.chunk:
                sl = slice(off, off + self.chunk)
                self._flush_chunk(ys[sl], us[sl], vs[sl], ts_all[sl])
                off += self.chunk
            self._buf = [(ys[off:], us[off:], vs[off:])] if off < self._buf_n else []
            self._buf_ts = [ts_all[off:]] if off < self._buf_n else []
            self._buf_n -= off

    def add_packed(self, packed: np.ndarray, ts: np.ndarray) -> None:
        """Feed pre-computed per-frame values for ``len(ts)`` frames.

        ``packed``: (len(VALUE_KEYS), n) float32 rows in VALUE_KEYS order —
        the complexity rows of the merged quality+complexity chunk program
        (``metrics.full_reference._program_chunk_combined``), whose device
        tail-carry replaces this accumulator's own chunking. Must not be mixed
        with buffered ``add()`` feeding (the two carry chains would diverge).
        """
        if self._buf_n:
            raise RuntimeError("add_packed cannot be mixed with pending add()")
        n = len(ts)
        if n == 0:
            return
        for row, k in enumerate(VALUE_KEYS):
            self.values[k].append(np.asarray(packed[row, :n], np.float32))
        self.timestamps.append(np.asarray(ts, np.float64))
        self.n_total += n

    def _consolidate(self) -> None:
        if len(self._buf) > 1:
            self._buf = [
                tuple(np.concatenate([b[i] for b in self._buf]) for i in range(3))
            ]
            self._buf_ts = [np.concatenate(self._buf_ts)]

    def _drain(self, n: int) -> None:
        """Flush the first ``n`` pending frames (used for the ragged tail)."""
        self._consolidate()
        ys, us, vs = self._buf[0]
        ts = self._buf_ts[0]
        self._buf = [(ys[n:], us[n:], vs[n:])] if n < self._buf_n else []
        self._buf_ts = [ts[n:]] if n < self._buf_n else []
        self._buf_n -= n
        self._flush_chunk(ys[:n], us[:n], vs[:n], ts[:n])

    def _flush_chunk(self, y, u, v, ts) -> None:
        n = y.shape[0]
        if self._prev_tail is None:
            # Global slot 0 has no predecessor; feed zeros — its value is
            # dropped by the series re-indexing in finalize anyway.
            tail = (np.zeros_like(y[:1])[0], np.zeros_like(u[:1])[0],
                    np.zeros_like(v[:1])[0])
        else:
            tail = self._prev_tail

        # Pad the ragged tail chunk to the static chunk size.
        pad = self.chunk - n
        if pad:
            def p(a):
                return np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)
            yp, up, vp = p(y), p(u), p(v)
        else:
            yp, up, vp = y, u, v

        # Explicit staging: each plane is uploaded once. The previous-frame
        # operand is built on device inside _chunk_values from the carried
        # device tail (no double upload).
        dy, du, dv = jax.device_put(yp), jax.device_put(up), jax.device_put(vp)
        packed = np.asarray(
            _chunk_values(
                dy, du, dv, *(jax.device_put(t) for t in tail),
                resize_h=self.resize_height, resize_w=self.resize_width,
                block=self.block, radius=self.radius,
                motion_search=self.motion_search,
            )
        )  # one fetch per chunk
        # Carry the last VALID frame as the next chunk's tail, on device
        # (slicing the staged array costs no host round trip).
        self._prev_tail = (dy[n - 1], du[n - 1], dv[n - 1])
        for row, k in enumerate(VALUE_KEYS):
            self.values[k].append(packed[row, :n])
        self.timestamps.append(ts)
        self.n_total += n

    def finalize(self) -> ComplexityResult:
        if self._buf_n:
            self._drain(self._buf_n)
        if self.n_total < 2:
            return ComplexityResult(**{k: 0.0 for k in METRIC_ORDER})

        series = {k: np.concatenate(v) for k, v in self.values.items()}
        ts = np.concatenate(self.timestamps)
        a = self.alpha

        out = {}
        for k in ("motion", "dct", "histogram", "edge", "orb", "color"):
            out[k] = _ewm_mean_host(series[k][1:], a)        # slots g=1..N-1
        out["temporal_dct"] = _ewm_mean_host(series["temporal_dct"][2:], a)
        dt = np.diff(ts) / 1000.0
        fps = np.where(dt > 0, 1.0 / np.maximum(dt, 1e-9), 0.0)
        out["framerate"] = _ewm_mean_host(fps, a)
        return ComplexityResult(**out)


def calculate_average_scene_complexity_streaming(
    video_path: str,
    resize_width: int,
    resize_height: int,
    frame_interval: int = 10,
    smoothing_factor: float = 0.8,
    chunk: int = 32,
    block: int = 16,
    radius: int = 8,
    motion_search: str = "pyramid",
) -> ComplexityResult:
    """Streaming equivalent of `calculate_average_scene_complexity`."""
    acc = ComplexityAccumulator(
        resize_width, resize_height, smoothing_factor, chunk, block, radius,
        motion_search,
    )
    it = prefetch(VideoStream(video_path, frame_interval, chunk), depth=1)
    for fb in it:
        acc.add(fb.y, fb.u, fb.v, fb.timestamps_ms)
    return acc.finalize()
