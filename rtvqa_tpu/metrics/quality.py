"""Full-reference quality metrics: PSNR + SSIM, FFmpeg-filter semantics.

Replaces the reference's ``run_ffmpeg_metrics`` subprocess
(``video_processing.py:270-297``) with on-device reductions over YUV420 frame
batches (every frame, full resolution — BASELINE.json configs[1]).

**PSNR** (libavfilter vf_psnr semantics): per frame, MSE per plane; the
frame's ``mse_avg`` is total SSE over total pixel count across Y,U,V; the
pooled PSNR is ``10*log10(MAX^2 / mean-over-frames(mse_avg))`` — FFmpeg's
summary "average". (The reference's regex actually grabs frame 1's
``psnr_avg`` — first ``re.search`` match over the stats file,
``video_processing.py:160`` — a latent bug; we pool correctly and also expose
the per-frame series.)

**SSIM** (libavfilter vf_ssim, the x264 algorithm — NOT the Gaussian-window
Wang et al. form): per plane,

1. 4x4 block sums of ref, dist, ref^2+dist^2, ref*dist;
2. each SSIM window aggregates a 2x2 group of adjacent 4x4 blocks (8x8 area,
   stride 4), giving ``(h//4-1) * (w//4-1)`` windows;
3. ``ssim_end1`` with x264's integer constants::

       c1 = int(.01*.01*255*255*64 + .5)        = 416
       c2 = int(.03*.03*255*255*64*63 + .5)     = 235963
       vars  = ss*64 - s1*s1 - s2*s2
       covar = s12*64 - s1*s2
       ssim  = (2*s1*s2 + c1)*(2*covar + c2)
             / ((s1*s1 + s2*s2 + c1)*(vars + c2))

4. plane score = mean over windows; frame "All" = plane scores weighted by
   plane pixel counts (4/6, 1/6, 1/6 for 4:2:0); pooled = mean over frames.

Precision note: block/window sums are computed in int32 (exact, as in x264's
integer pipeline); the rational is evaluated in float32 — products fit well
inside f32's 24-bit mantissa error budget for the 1e-4 parity target.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SSIM_C1 = int(0.01 * 0.01 * 255 * 255 * 64 + 0.5)         # 416
_SSIM_C2 = int(0.03 * 0.03 * 255 * 255 * 64 * 63 + 0.5)    # 235963


# ---------------------------------------------------------------------------
# PSNR
# ---------------------------------------------------------------------------


def _plane_sse(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.sum(d * d, axis=(-2, -1))


@jax.jit
def psnr_frames(
    ref_y, ref_u, ref_v, dis_y, dis_u, dis_v
) -> dict[str, jnp.ndarray]:
    """Per-frame MSE/PSNR over (N,H,W)+(N,h,w)x2 planes (vf_psnr semantics)."""
    n_y = ref_y.shape[-2] * ref_y.shape[-1]
    n_c = ref_u.shape[-2] * ref_u.shape[-1]
    sse_y = _plane_sse(ref_y, dis_y)
    sse_u = _plane_sse(ref_u, dis_u)
    sse_v = _plane_sse(ref_v, dis_v)
    mse_y = sse_y / n_y
    mse_u = sse_u / n_c
    mse_v = sse_v / n_c
    mse_avg = (sse_y + sse_u + sse_v) / (n_y + 2 * n_c)

    def to_psnr(mse):
        # FFmpeg reports "inf" for zero MSE (identical frames) — reproduced
        # exactly; finite values are untouched.
        finite = 10.0 * jnp.log10((255.0 * 255.0) / jnp.maximum(mse, 1e-30))
        return jnp.where(mse > 0.0, finite, jnp.inf)

    return {
        "mse_y": mse_y, "mse_u": mse_u, "mse_v": mse_v, "mse_avg": mse_avg,
        "psnr_y": to_psnr(mse_y), "psnr_avg": to_psnr(mse_avg),
    }


def pooled_psnr(mse_avg_frames: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """FFmpeg global average: PSNR of the mean frame MSE (``inf`` when the
    streams are identical, as vf_psnr's summary line prints)."""
    validf = valid.astype(jnp.float32)
    mean_mse = jnp.sum(mse_avg_frames * validf) / jnp.maximum(jnp.sum(validf), 1.0)
    finite = 10.0 * jnp.log10((255.0 * 255.0) / jnp.maximum(mean_mse, 1e-30))
    return jnp.where(mean_mse > 0.0, finite, jnp.inf)


# ---------------------------------------------------------------------------
# SSIM (x264 / vf_ssim algorithm)
# ---------------------------------------------------------------------------


def _block_sums_4x4(a: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) int -> (..., H//4, W//4) float32 4x4 block sums (truncating
    partial blocks at the border, as vf_ssim does via width>>2).

    An integer reshape-and-sum: exact, as x264's integer pipeline is.
    """
    h, w = (a.shape[-2] // 4) * 4, (a.shape[-1] // 4) * 4
    x = a[..., :h, :w].astype(jnp.int32)
    x = x.reshape(*x.shape[:-2], h // 4, 4, w // 4, 4)
    return jnp.sum(x, axis=(-3, -1)).astype(jnp.float32)


def _ssim_plane(ref: jnp.ndarray, dis: jnp.ndarray) -> jnp.ndarray:
    """Per-frame x264 SSIM score of one plane: (..., H, W) uint8 -> (...,)."""
    r = ref.astype(jnp.int32)
    d = dis.astype(jnp.int32)
    s1 = _block_sums_4x4(r)
    s2 = _block_sums_4x4(d)
    ss = _block_sums_4x4(r * r + d * d)
    s12 = _block_sums_4x4(r * d)

    def win(x):  # 2x2 aggregation of adjacent blocks -> 8x8 windows stride 4
        return x[..., :-1, :-1] + x[..., :-1, 1:] + x[..., 1:, :-1] + x[..., 1:, 1:]

    w1 = win(s1).astype(jnp.float32)
    w2 = win(s2).astype(jnp.float32)
    wss = win(ss).astype(jnp.float32)
    w12 = win(s12).astype(jnp.float32)

    vars_ = wss * 64.0 - w1 * w1 - w2 * w2
    covar = w12 * 64.0 - w1 * w2
    num = (2.0 * w1 * w2 + _SSIM_C1) * (2.0 * covar + _SSIM_C2)
    den = (w1 * w1 + w2 * w2 + _SSIM_C1) * (vars_ + _SSIM_C2)
    return jnp.mean(num / den, axis=(-2, -1))


@jax.jit
def ssim_frames(
    ref_y, ref_u, ref_v, dis_y, dis_u, dis_v
) -> dict[str, jnp.ndarray]:
    """Per-frame SSIM Y/U/V/All for YUV420 batches (vf_ssim semantics)."""
    sy = _ssim_plane(ref_y, dis_y)
    su = _ssim_plane(ref_u, dis_u)
    sv = _ssim_plane(ref_v, dis_v)
    n_y = ref_y.shape[-2] * ref_y.shape[-1]
    n_c = ref_u.shape[-2] * ref_u.shape[-1]
    total = n_y + 2 * n_c
    all_ = (sy * n_y + su * n_c + sv * n_c) / total
    return {"ssim_y": sy, "ssim_u": su, "ssim_v": sv, "ssim_all": all_}


def pooled_mean(per_frame: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    validf = valid.astype(jnp.float32)
    return jnp.sum(per_frame * validf) / jnp.maximum(jnp.sum(validf), 1.0)


# ---------------------------------------------------------------------------
# Batched host driver (chunked over frames to bound device residency)
# ---------------------------------------------------------------------------


def compute_quality(ref_clip, dis_clip, chunk: int = 32) -> dict[str, float]:
    """PSNR + SSIM between two decoded clips (every frame, full res).

    Frames stream to the device in fixed-size chunks (one compiled executable,
    ragged tail padded + masked), accumulating per-frame series on host.
    """
    n = min(ref_clip.y.shape[0], dis_clip.y.shape[0])
    mse_avg, psnr_y, ssim_all, ssim_y = [], [], [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        sl = slice(start, end)
        pad = chunk - (end - start)

        def prep(a):
            a = a[sl]
            if pad:
                a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
            return a

        args = tuple(
            prep(x)
            for x in (
                ref_clip.y, ref_clip.u, ref_clip.v,
                dis_clip.y, dis_clip.u, dis_clip.v,
            )
        )
        p = psnr_frames(*args)
        s = ssim_frames(*args)
        k = end - start
        mse_avg.append(np.asarray(p["mse_avg"])[:k])
        psnr_y.append(np.asarray(p["psnr_y"])[:k])
        ssim_all.append(np.asarray(s["ssim_all"])[:k])
        ssim_y.append(np.asarray(s["ssim_y"])[:k])

    mse = np.concatenate(mse_avg) if mse_avg else np.zeros(0, np.float32)
    valid = np.ones_like(mse, bool)
    return {
        "psnr": float(np.asarray(pooled_psnr(jnp.asarray(mse), jnp.asarray(valid)))),
        "psnr_frames": np.concatenate(psnr_y) if psnr_y else mse,
        "ssim": float(np.mean(np.concatenate(ssim_all))) if ssim_all else 0.0,
        "ssim_frames": np.concatenate(ssim_all) if ssim_all else mse,
        "n_frames": int(n),
    }
