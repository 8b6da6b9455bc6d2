"""Multi-clip batched complexity analysis over a device mesh.

BASELINE.json configs[4]: "Batched CRF ladder sweep over a multi-clip corpus,
frames sharded across chips." `pipeline.sweep` handles the ladder + resume
manifest; this module supplies the device-parallel analysis step it (or a
user) can drive directly: a same-resolution corpus of clips is stacked into
(C, N, H, W) batches and analyzed with `parallel.sharded_complexity_suite` —
clips data-parallel over the mesh's "clip" axis, each clip's frame/time axis
sequence-parallel over the "frame" axis (1-frame halo).

Clips of differing lengths pad to the corpus maximum (bucketed) with per-clip
valid counts — the masked EWM makes padding exact, so results equal per-clip
single-device analysis (tested in tests/test_sharding.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from rtvqa_tpu.io import video as vio
from rtvqa_tpu.metrics.complexity import ComplexityResult, _pad_bucket
from rtvqa_tpu.obs.logging import get_logger

logger = get_logger("rtvqa_tpu.batch")


def analyze_clips_sharded(
    video_paths: Sequence[str],
    resize_width: int,
    resize_height: int,
    frame_interval: int = 10,
    smoothing_factor: float = 0.8,
    mesh=None,
    n_clip_shards: Optional[int] = None,
    motion_search: str = "pyramid",
) -> list[ComplexityResult]:
    """Complexity suite for a same-resolution corpus, sharded over the mesh.

    Returns one ComplexityResult per input clip (order preserved).
    """
    clips = [vio.decode_sampled(p, frame_interval) for p in video_paths]
    return complexity_sharded_clips(
        clips, resize_width, resize_height, smoothing_factor, mesh,
        n_clip_shards, motion_search,
    )


def complexity_sharded_clips(
    clips: Sequence,
    resize_width: int,
    resize_height: int,
    smoothing_factor: float = 0.8,
    mesh=None,
    n_clip_shards: Optional[int] = None,
    motion_search: str = "pyramid",
) -> list[ComplexityResult]:
    """``analyze_clips_sharded`` over already-sampled clips (anything with
    ``y``/``u``/``v``/``timestamps_ms`` arrays, e.g. ``io.video.DecodedClip``)."""
    import jax

    from rtvqa_tpu.parallel.sharding import make_mesh, sharded_complexity_suite

    shapes = {c.y.shape[1:] for c in clips}
    if len(shapes) != 1:
        raise ValueError(f"corpus must share one resolution, got {shapes}")

    if mesh is None:
        n_dev = jax.device_count()
        n_clip = n_clip_shards or (2 if n_dev % 2 == 0 and n_dev > 1 else 1)
        mesh = make_mesh(n_clip=n_clip, n_frame=n_dev // n_clip)

    clip_shards = mesh.devices.shape[0]
    frame_shards = mesh.devices.shape[1]

    c_real = len(clips)
    c_pad = -(-c_real // clip_shards) * clip_shards
    n_max = max(c.y.shape[0] for c in clips)
    n_pad = _pad_bucket(n_max, bucket=max(16, frame_shards))
    # frame axis must divide evenly across frame shards
    n_pad = -(-n_pad // frame_shards) * frame_shards

    h, w = clips[0].y.shape[1:]
    ch, cw = clips[0].u.shape[1:]
    y = np.zeros((c_pad, n_pad, h, w), np.uint8)
    u = np.zeros((c_pad, n_pad, ch, cw), np.uint8)
    v = np.zeros((c_pad, n_pad, ch, cw), np.uint8)
    ts = np.zeros((c_pad, n_pad), np.float32)
    n_valid = np.zeros((c_pad,), np.int32)
    for i, c in enumerate(clips):
        n = c.y.shape[0]
        y[i, :n], u[i, :n], v[i, :n] = c.y, c.u, c.v
        ts[i, :n] = c.timestamps_ms
        n_valid[i] = n

    fn = sharded_complexity_suite(
        mesh,
        resize_h=resize_height,
        resize_w=resize_width,
        alpha=float(smoothing_factor),
        motion_search=motion_search,
    )
    out = fn(y, u, v, ts, n_valid)
    out = {k: np.asarray(val) for k, val in out.items()}
    return [
        ComplexityResult(**{k: float(val[i]) for k, val in out.items()})
        for i in range(c_real)
    ]
