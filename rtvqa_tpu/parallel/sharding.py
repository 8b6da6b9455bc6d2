"""Multi-chip execution: device mesh + shard_map'd complexity suite.

The reference's only parallelism is a host process pool over pickled frames
(``complexity_metrics.py:128-148`` — SURVEY.md §2.3). The on-device
equivalents:

* **intra-chip data parallelism**: every kernel is batched over the frame
  axis (one fused XLA program — `metrics.complexity`);
* **multi-chip**: a 2D ``Mesh`` ("clip", "frame"); clips shard over one axis
  (pure data parallelism), the frame/time axis of each clip shards over the
  other — the framework's analog of sequence/context parallelism (SURVEY.md
  §2.3 SP row). Temporal metrics (block-matching motion, temporal DCT, fps
  variation) need exactly one predecessor frame per shard boundary: a single
  ``ppermute`` halo exchange sends each shard's last frame to its right
  neighbor (NVLink between GPUs of one host).

Design: each shard computes *per-global-frame* metric values for its local
frames (all metrics depend only on frame g and g-1 — the halo). The per-frame
scalar series (8 floats per frame) are then ``all_gather``ed — a negligible
collective — and the EWM smoothing + masked means run replicated via the
associative scan. Collective bytes per step: one frame per boundary + 8N
scalars; everything heavy stays local.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from rtvqa_tpu.metrics.complexity import ORB_SIZE
from rtvqa_tpu.ops.color import yuv420_to_gray
from rtvqa_tpu.ops.dct import dct_energy, temporal_dct_abs_diff
from rtvqa_tpu.ops.edges import canny_edge_count
from rtvqa_tpu.ops.histogram import color_entropy_sampled, gray_entropy
from rtvqa_tpu.ops.motion import (
    block_match_motion,
    block_match_motion_pyramid,
    block_match_motion_pyramid_series,
)
from rtvqa_tpu.vmaf.filters import filter1d_sep
from rtvqa_tpu.vmaf.motion import FILTER_5
from rtvqa_tpu.ops.orb import orb_keypoint_count
from rtvqa_tpu.ops.resize import resize_bilinear
from rtvqa_tpu.ops.scan import ewm_mean_masked, masked_mean


def make_mesh(n_clip: int = 1, n_frame: Optional[int] = None, devices=None) -> Mesh:
    """Build a ("clip", "frame") mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = devices.size
    if n_frame is None:
        n_frame = total // n_clip
    assert n_clip * n_frame == total, (n_clip, n_frame, total)
    return Mesh(devices.reshape(n_clip, n_frame), axis_names=("clip", "frame"))


def _per_frame_values(
    y, u, v, prev_y, prev_u, prev_v, *,
    resize_h, resize_w, block, radius, edge_low, edge_high,
    motion_search="pyramid",
):
    """All eight per-frame metric values for a local frame block.

    ``prev_*`` are the same arrays shifted by one global frame (halo-filled at
    shard boundaries). Shapes (..., Nl, H, W) -> each output (..., Nl).
    """
    gray = yuv420_to_gray(y, u, v)
    prev_gray = yuv420_to_gray(prev_y, prev_u, prev_v)

    if motion_search == "pyramid":
        motion = block_match_motion_pyramid(
            prev_gray, gray, block=block, radius=radius
        )
    else:
        motion = block_match_motion(prev_gray, gray, block=block, radius=radius)

    gray_rs = resize_bilinear(gray, resize_h, resize_w)
    prev_gray_rs = resize_bilinear(prev_gray, resize_h, resize_w)
    dct = dct_energy(gray_rs)
    hist = gray_entropy(gray_rs)
    edge = canny_edge_count(gray_rs, edge_low, edge_high)
    orb = orb_keypoint_count(resize_bilinear(gray, ORB_SIZE, ORB_SIZE))
    # Sampled-rows color path (bitwise-equal to full-res convert + resize;
    # ops.histogram.color_entropy_sampled).
    color = color_entropy_sampled(y, u, v, resize_h, resize_w)
    tdct = temporal_dct_abs_diff(prev_gray_rs, gray_rs)
    return {
        "motion": motion, "dct": dct, "histogram": hist, "edge": edge,
        "orb": orb, "color": color, "temporal_dct": tdct,
    }


def _per_frame_values_series(
    y_ext, u_ext, v_ext, *,
    resize_h, resize_w, block, radius, edge_low, edge_high,
    motion_search="pyramid",
):
    """Series form of ``_per_frame_values`` for one prev-prepended frame
    series (N+1, H, W): gray conversion, resize, and the pyramid downsample
    run ONCE over N+1 frames instead of twice over N (they are
    memory-bound — the pairwise form re-reads 99%-overlapping slices).
    Returns per-frame values for the N trailing frames.

    Used by the streaming accumulator; the sharded suite keeps the pairwise
    form (its prev frames arrive as a ppermute halo, not a series slice).
    """
    gray_ext = yuv420_to_gray(y_ext, u_ext, v_ext)

    if motion_search == "pyramid":
        motion = block_match_motion_pyramid_series(
            gray_ext, block=block, radius=radius
        )
    else:
        motion = block_match_motion(
            gray_ext[:-1], gray_ext[1:], block=block, radius=radius
        )

    gray_rs_ext = resize_bilinear(gray_ext, resize_h, resize_w)
    gray_rs = gray_rs_ext[1:]
    dct = dct_energy(gray_rs)
    hist = gray_entropy(gray_rs)
    edge = canny_edge_count(gray_rs, edge_low, edge_high)
    orb = orb_keypoint_count(resize_bilinear(gray_ext[1:], ORB_SIZE, ORB_SIZE))
    # Sampled-rows color path (bitwise-equal to full-res convert + resize;
    # ops.histogram.color_entropy_sampled).
    color = color_entropy_sampled(
        y_ext[1:], u_ext[1:], v_ext[1:], resize_h, resize_w
    )
    tdct = temporal_dct_abs_diff(gray_rs_ext[:-1], gray_rs)
    return {
        "motion": motion, "dct": dct, "histogram": hist, "edge": edge,
        "orb": orb, "color": color, "temporal_dct": tdct,
    }


def _series_reduce(vals: dict, timestamps_ms, n_valid, alpha: float):
    """Replicated tail: re-index per-frame values into the reference's series,
    EWM-smooth, masked-mean. ``vals[*]``: (..., N); timestamps (..., N)."""
    n = vals["motion"].shape[-1]
    idx = jnp.arange(n)

    def sm(series, valid):
        smoothed, vv = ewm_mean_masked(series, alpha, valid, axis=-1)
        return masked_mean(smoothed, vv, axis=-1)

    nv = n_valid[..., None] if n_valid.ndim else n_valid
    pair_valid = (idx[1:] >= 1) & (idx[1:] < nv)          # slots g=1..N-1
    tdct_valid = idx[2:] < nv                              # slots g=2..N-1

    out = {}
    for key in ("motion", "dct", "histogram", "edge", "orb", "color"):
        out[key] = sm(vals[key][..., 1:], pair_valid)
    out["temporal_dct"] = sm(vals["temporal_dct"][..., 2:], tdct_valid)

    ts = timestamps_ms.astype(jnp.float32)
    dt = (ts[..., 1:] - ts[..., :-1]) / 1000.0
    fps = jnp.where(dt > 0, 1.0 / jnp.maximum(dt, 1e-9), 0.0)
    out["framerate"] = sm(fps, pair_valid)
    return out


def sharded_complexity_suite(
    mesh: Mesh,
    *,
    resize_h: int,
    resize_w: int,
    alpha: float = 0.8,
    block: int = 16,
    radius: int = 8,
    edge_low: float = 100.0,
    edge_high: float = 200.0,
    motion_search: str = "pyramid",
):
    """Build the jitted multi-chip complexity step for a given mesh.

    Returns ``fn(y, u, v, timestamps_ms, n_valid) -> dict of (C,) metrics``
    with inputs of shape (C, N, H, W)/(C, N, h, w)/(C, N)/(C,); C must divide
    the mesh's "clip" axis size and N its "frame" axis size.
    """
    kernel = functools.partial(
        _per_frame_values,
        resize_h=resize_h, resize_w=resize_w, block=block, radius=radius,
        edge_low=edge_low, edge_high=edge_high, motion_search=motion_search,
    )

    def body(y, u, v, ts, n_valid):
        # Halo: previous global frame of the first local frame = left
        # neighbor's last local frame (zeros for shard 0 — its slot-0 values
        # are masked out anyway: the series start at g=1).
        def with_halo(x):
            last = x[:, -1:]
            halo = jax.lax.ppermute(
                last, "frame",
                [(i, (i + 1) % jax.lax.axis_size("frame"))
                 for i in range(jax.lax.axis_size("frame"))],
            )
            fid = jax.lax.axis_index("frame")
            halo = jnp.where(fid == 0, jnp.zeros_like(halo), halo)
            return jnp.concatenate([halo, x[:, :-1]], axis=1)

        vals = kernel(y, u, v, with_halo(y), with_halo(u), with_halo(v))
        # Gather the tiny scalar series; compute the smoothing replicated.
        vals = {k: jax.lax.all_gather(val, "frame", axis=1, tiled=True)
                for k, val in vals.items()}
        ts_full = jax.lax.all_gather(ts, "frame", axis=1, tiled=True)
        out = _series_reduce(vals, ts_full, n_valid, alpha)
        # Replicated within the clip row -> psum/identity not needed; out is
        # identical on every frame-shard.
        return out

    spec_frames = P("clip", "frame", None, None)
    spec_ts = P("clip", "frame")
    spec_scalar = P("clip")

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(spec_frames, spec_frames, spec_frames, spec_ts, spec_scalar),
        out_specs={k: spec_scalar for k in (
            "motion", "dct", "histogram", "edge", "orb", "color",
            "temporal_dct", "framerate",
        )},
        check_vma=False,
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Sharded full-reference quality step (PSNR/SSIM/VIF/ADM/motion over a mesh)
# ---------------------------------------------------------------------------


def sharded_quality_step(mesh: Mesh, vif_egl=None, adm_egl=None):
    """Build the multi-chip full-reference step for one whole clip pair.

    ``vif_egl``/``adm_egl``: NEG-mode enhancement-gain limits from the model
    file's ``feature_opts_dicts`` (None = classic VIF/ADM).

    Shards the frame axis over the mesh's "frame" axis (pure per-frame data
    parallelism for PSNR/SSIM/VIF/ADM; VMAF motion needs the previous frame's
    blurred luma — one ppermute halo, as in the complexity step). Returns
    ``fn(ry, ru, rv, dy, du, dv) -> (K, N) packed float32`` with row order
    ``metrics.full_reference.CHUNK_KEYS``; the global slot-0 motion SAD is
    taken against a zero frame (callers zero it, matching program A's
    has_prev masking).
    """
    step = sharded_quality_chunk_step(mesh, vif_egl=vif_egl, adm_egl=adm_egl)

    def fn(ry, ru, rv, dy, du, dv):
        zeros = jnp.zeros(ry.shape[-2:], jnp.float32)
        packed, _ = step(ry, ru, rv, dy, du, dv, zeros, np.bool_(True))
        return packed

    return fn


def sharded_quality_chunk_step(mesh: Mesh, vif_egl=None, adm_egl=None):
    """Streaming multi-chip full-reference step: one CHUNK of the clip per
    call, with the motion-blur carry threaded across chunks so device memory
    stays bounded by the chunk size regardless of clip length (composes with
    the lockstep chunk loop of
    ``metrics.full_reference._run_quality_chunks``).

    Returns ``fn(ry, ru, rv, dy, du, dv, prev_blur, has_prev) ->
    (packed (K, chunk), blur_lasts (n_frame_shards, H, W))``: ``prev_blur``
    is the blurred last ref-luma of the previous chunk (replicated);
    ``blur_lasts[-1]`` is the next chunk's carry. The chunk (frame axis of
    the inputs) must be a multiple of the mesh's "frame" axis.
    """
    from rtvqa_tpu.metrics.full_reference import A_KEYS, B_KEYS
    from rtvqa_tpu.metrics.quality import psnr_frames, ssim_frames
    from rtvqa_tpu.vmaf.adm import adm_features
    from rtvqa_tpu.vmaf.vif import vif_features

    def body(ry, ru, rv, dy, du, dv, prev_blur, has_prev):
        out = {}
        out.update(psnr_frames(ry, ru, rv, dy, du, dv))
        out.update(ssim_frames(ry, ru, rv, dy, du, dv))
        ryf = ry.astype(jnp.float32)
        dyf = dy.astype(jnp.float32)
        out.update(vif_features(ryf, dyf, enhn_gain_limit=vif_egl))
        out.update(adm_features(ryf, dyf, enhn_gain_limit=adm_egl))

        blur = filter1d_sep(ryf, FILTER_5)
        n_frame = jax.lax.axis_size("frame")
        halo = jax.lax.ppermute(
            blur[-1:], "frame", [(i, (i + 1) % n_frame) for i in range(n_frame)]
        )
        fid = jax.lax.axis_index("frame")
        # Shard 0's halo is the PREVIOUS CHUNK's carry.
        halo = jnp.where(fid == 0, prev_blur[None].astype(jnp.float32), halo)
        prev = jnp.concatenate([halo, blur[:-1]], axis=0)
        sad = jnp.mean(jnp.abs(blur - prev), axis=(-2, -1))
        # Global frame 0 of the whole CLIP has no predecessor.
        sad = sad.at[0].set(
            jnp.where((fid == 0) & jnp.logical_not(has_prev), 0.0, sad[0])
        )
        out["motion_sad"] = sad

        packed = jnp.stack(
            [out[k].astype(jnp.float32) for k in (*A_KEYS, *B_KEYS)]
        )
        return (
            jax.lax.all_gather(packed, "frame", axis=1, tiled=True),
            blur[-1:],
        )

    spec = P("frame", None, None)
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,) * 6 + (P(None, None), P()),
        out_specs=(P(), P("frame", None, None)),
        check_vma=False,
    )
    return jax.jit(fn)
