"""The eight-metric scene-complexity suite as one jitted device program.

Reference: ``calculate_average_scene_complexity`` (``complexity_metrics.py:
246-310``) — seven ProcessPoolExecutor passes over host frame lists plus two
extra full decodes. Here the whole suite is ONE jit-compiled function over
YUV frame batches resident in device memory: gray/RGB conversion, resizes
(small matmuls), all metric kernels, EWM smoothing (associative scan) and means fuse
into a single XLA program; the clip is decoded exactly once (SURVEY.md
§2.4(3) fixed).

Sampled-frame semantics (matching ``read_frame_pairs``,
``complexity_metrics.py:76-111``): with sampled frames ``s[0..n-1]`` (every
``frame_interval``-th source frame), pairs are ``(s[j+1], s[j])``; motion runs
on pairs; the spatial metrics run on the first-of-pair frames ``s[1:]``;
temporal DCT runs on consecutive first-of-pair frames; framerate variation on
consecutive sampled timestamps — timestamps of the SAME frames (the
reference's off-by-one between its timestamp pass and its frame pass,
SURVEY.md §2.4(4), is unified here).

Padding: inputs are padded along the frame axis to a static bucket size with
a validity count, so clips of any length reuse one compiled executable.
Invalid slots are threaded through the masked EWM (skip semantics) and masked
means. Empty series yield 0.0 (the reference yields NaN from ``np.mean([])``
for most metrics but 0.0 for temporal DCT, ``complexity_metrics.py:541``; we
use 0.0 uniformly — documented divergence).

Metric order of the result tuple matches the reference's *return* order
(``complexity_metrics.py:301-310``), and the CSV mapping downstream is the
corrected one (SURVEY.md §2.4(1)).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.ops.color import yuv420_to_gray
from rtvqa_tpu.ops.dct import dct_energy, temporal_dct_abs_diff
from rtvqa_tpu.ops.edges import canny_edge_count
from rtvqa_tpu.ops.histogram import color_entropy_sampled, gray_entropy
from rtvqa_tpu.ops.motion import (
    block_match_motion,
    block_match_motion_pyramid_series,
    fps_variation,
)
from rtvqa_tpu.ops.orb import orb_keypoint_count
from rtvqa_tpu.ops.resize import resize_bilinear
from rtvqa_tpu.ops.scan import ewm_mean_masked, masked_mean

# Reference hard-codes ORB's input size to 64x64 regardless of config resize
# dims (complexity_metrics.py:379,386; SURVEY.md §2.4(6)). Kept: the metric's
# published scale depends on it.
ORB_SIZE = 64


@dataclasses.dataclass(frozen=True)
class ComplexityResult:
    """The 8-tuple of ``calculate_average_scene_complexity`` with true labels."""

    motion: float
    dct: float
    histogram: float
    edge: float
    orb: float
    color: float
    temporal_dct: float
    framerate: float

    def as_tuple(self) -> tuple:
        # Reference return order (complexity_metrics.py:301-310).
        return (
            self.motion, self.dct, self.histogram, self.edge,
            self.orb, self.color, self.temporal_dct, self.framerate,
        )


def _smoothed_masked_mean(series: jnp.ndarray, valid: jnp.ndarray, alpha: float) -> jnp.ndarray:
    sm, v = ewm_mean_masked(series, alpha, valid)
    return masked_mean(sm, v)


@functools.partial(
    jax.jit,
    static_argnames=(
        "resize_h", "resize_w", "alpha", "block", "radius", "edge_low",
        "edge_high", "motion_search",
    ),
)
def complexity_suite(
    y: jnp.ndarray,           # (N, H, W) uint8 sampled luma
    u: jnp.ndarray,           # (N, H/2, W/2) uint8
    v: jnp.ndarray,           # (N, H/2, W/2) uint8
    timestamps_ms: jnp.ndarray,  # (N,) float32
    n_valid: jnp.ndarray,     # () int32 — number of real (unpadded) frames
    *,
    resize_h: int,
    resize_w: int,
    alpha: float = 0.8,
    block: int = 16,
    radius: int = 8,
    edge_low: float = 100.0,
    edge_high: float = 200.0,
    motion_search: str = "pyramid",
) -> dict[str, jnp.ndarray]:
    """Full complexity suite on padded sampled-frame batches; returns the 8
    smoothed-mean scalars keyed by metric name.

    ``motion_search``: "pyramid" (default — half-res coarse search, the
    reference Farneback's own pyramid analog, ~14x less arithmetic) or
    "full" (exhaustive full-resolution search); see ops.motion.
    """
    n_pad = y.shape[0]
    idx = jnp.arange(n_pad)

    gray_full = yuv420_to_gray(y, u, v)                      # (N, H, W) f32

    curr_g = gray_full[1:]
    prev_g = gray_full[:-1]
    pair_valid = idx[1:] < n_valid                            # (N-1,)

    # -- motion: block matching on full-res gray pairs (reference runs
    #    Farneback unresized, complexity_metrics.py:313-343).
    if motion_search == "pyramid":
        motion_series = block_match_motion_pyramid_series(
            gray_full, block=block, radius=radius
        )
    else:
        motion_series = block_match_motion(prev_g, curr_g, block=block, radius=radius)

    # -- spatial metrics on first-of-pair frames s[1:] (dense matmul resize).
    gray_rs = resize_bilinear(curr_g, resize_h, resize_w)
    dct_series = dct_energy(gray_rs)
    hist_series = gray_entropy(gray_rs)
    edge_series = canny_edge_count(gray_rs, edge_low, edge_high)

    gray_orb = resize_bilinear(curr_g, ORB_SIZE, ORB_SIZE)
    orb_series = orb_keypoint_count(gray_orb)

    # Color path: sampled-rows convert + resize + entropy (bitwise-equal to
    # full-res convert + resize; see ops.histogram.color_entropy_sampled).
    color_series = color_entropy_sampled(
        y[1:], u[1:], v[1:], resize_h, resize_w
    )

    # -- temporal DCT on consecutive first-of-pair frames (N-2 values),
    #    reference calculate_temporal_dct (complexity_metrics.py:506-541).
    tdct_series = temporal_dct_abs_diff(gray_rs[:-1], gray_rs[1:])
    tdct_valid = idx[2:] < n_valid

    # -- framerate variation over all sampled timestamps (N-1 values).
    ts_valid = idx < n_valid
    fps_series, fps_valid = fps_variation(timestamps_ms, ts_valid)

    return {
        "motion": _smoothed_masked_mean(motion_series, pair_valid, alpha),
        "dct": _smoothed_masked_mean(dct_series, pair_valid, alpha),
        "histogram": _smoothed_masked_mean(hist_series, pair_valid, alpha),
        "edge": _smoothed_masked_mean(edge_series, pair_valid, alpha),
        "orb": _smoothed_masked_mean(orb_series, pair_valid, alpha),
        "color": _smoothed_masked_mean(color_series, pair_valid, alpha),
        "temporal_dct": _smoothed_masked_mean(tdct_series, tdct_valid, alpha),
        "framerate": _smoothed_masked_mean(fps_series, fps_valid, alpha),
    }


METRIC_ORDER = (
    "motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct", "framerate",
)


@functools.partial(
    jax.jit,
    static_argnames=(
        "resize_h", "resize_w", "alpha", "block", "radius", "edge_low",
        "edge_high", "motion_search",
    ),
)
def complexity_suite_packed(
    y, u, v, timestamps_ms, n_valid, *,
    resize_h, resize_w, alpha=0.8, block=16, radius=8,
    edge_low=100.0, edge_high=200.0, motion_search="pyramid",
) -> jnp.ndarray:
    """complexity_suite with the 8 scalars packed into one (8,) array — a
    single device->host fetch."""
    out = complexity_suite(
        y, u, v, timestamps_ms, n_valid,
        resize_h=resize_h, resize_w=resize_w, alpha=alpha, block=block,
        radius=radius, edge_low=edge_low, edge_high=edge_high,
        motion_search=motion_search,
    )
    return jnp.stack([out[k] for k in METRIC_ORDER])


def _pad_bucket(n: int, bucket: int = 16) -> int:
    """Round up to a bucket size so compiled executables are reused."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def calculate_average_scene_complexity(
    clip,
    resize_width: int,
    resize_height: int,
    smoothing_factor: float = 0.8,
    block: int = 16,
    radius: int = 8,
    motion_search: str = "pyramid",
) -> ComplexityResult:
    """Host-side wrapper: pad a DecodedClip to a static bucket, run the jitted
    suite, return the reference-ordered result (public API analog of
    ``complexity_metrics.py:246-310``)."""
    n = int(clip.y.shape[0])
    n_pad = _pad_bucket(n)

    def pad(a: np.ndarray) -> np.ndarray:
        width = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width)

    packed = np.asarray(
        complexity_suite_packed(
            pad(clip.y), pad(clip.u), pad(clip.v),
            pad(clip.timestamps_ms.astype(np.float32)),
            jnp.asarray(n, dtype=jnp.int32),
            resize_h=resize_height,
            resize_w=resize_width,
            alpha=float(smoothing_factor),
            block=block,
            radius=radius,
            motion_search=motion_search,
        )
    )
    return ComplexityResult(**{k: float(packed[i]) for i, k in enumerate(METRIC_ORDER)})


# --- standalone scorer (reference complexity_metrics.py:171-242) -----------

# Hard-coded normalization ranges (complexity_metrics.py:197-206). Two are
# recalibrated and documented: the reference's edge range (0,1) predates its
# raw-count kernel (SURVEY.md §2.4(9)), and motion's scale shifts with the
# block-matching substitution.
SCORE_RANGES = {
    "motion": (0.0, 10.0),
    "dct": (1e6, 5e7),
    "temporal_dct": (0.0, 1e7),
    "histogram": (0.0, 8.0),
    "edge": (0.0, 4096.0),  # raw edge-pixel count at 64x64 (recalibrated)
    "orb": (0.0, 5000.0),
    "color": (0.0, 8.0),
    "framerate": (0.0, 2.0),
}

# Weights (complexity_metrics.py:219-240).
SCORE_WEIGHTS = {
    "motion": 0.25,
    "dct": 0.15,
    "temporal_dct": 0.15,
    "histogram": 0.10,
    "edge": 0.10,
    "orb": 0.10,
    "color": 0.10,
    "framerate": 0.05,
}


def normalize(value: float, min_value: float, max_value: float) -> float:
    """Min-max scale (reference ``complexity_metrics.py:167-169``)."""
    return (value - min_value) / (max_value - min_value) if max_value > min_value else 0.0


def scene_complexity_score(result: ComplexityResult) -> float:
    """Weighted normalized scalar score (reference ``complexity_metrics.py:
    171-242``); same weights, recalibrated ranges per SCORE_RANGES."""
    vals = dataclasses.asdict(result)
    score = 0.0
    for key, weight in SCORE_WEIGHTS.items():
        lo, hi = SCORE_RANGES[key]
        score += weight * normalize(vals[key], lo, hi)
    return score


def calculate_scene_complexity_score(
    clip,
    resize_width: int,
    resize_height: int,
    smoothing_factor: float = 0.8,
    frame_interval: int = 10,
    num_workers=None,
    batch_size: int = 100,
) -> float:
    """End-to-end scorer over a decoded clip OR a media path (drop-in parity
    with the reference signature ``calculate_scene_complexity_score(
    encoded_video, resize_width, resize_height, frame_interval=10,
    smoothing_factor=0.8, num_workers=None, batch_size=100)`` —
    ``complexity_metrics.py:171``; VERDICT r3 missing #4).

    A string argument is decoded here: videos are sampled every
    ``frame_interval``-th frame; still images (``validate_video_path`` ->
    'frame' — a classification the reference defines but never consumes,
    VERDICT r3 missing #3) are analyzed as a STATIC one-frame scene: the
    frame is duplicated into one static pair, so the spatial metrics (DCT,
    histogram, edge, ORB, color) measure the image itself and the temporal
    metrics (motion, temporal DCT, framerate variation) are exactly 0.
    ``num_workers`` bounds decoder threads; ``batch_size`` is accepted for
    signature parity (the suite is a single fused program — device memory is
    bounded by the padded bucket, not a host batch size).
    """
    if isinstance(clip, str):
        from rtvqa_tpu.io import video as vio

        kind = vio.validate_video_path(clip)
        clip = vio.decode_sampled(
            clip,
            frame_interval=1 if kind == "frame" else frame_interval,
            threads=num_workers,
        )
        if kind == "frame":
            def dup(a):
                return np.repeat(a[:1], 2, axis=0)

            clip = dataclasses.replace(
                clip, y=dup(clip.y), u=dup(clip.u), v=dup(clip.v),
                timestamps_ms=np.repeat(clip.timestamps_ms[:1], 2),
            )
    res = calculate_average_scene_complexity(
        clip, resize_width, resize_height, smoothing_factor
    )
    return scene_complexity_score(res)
