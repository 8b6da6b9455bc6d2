"""Block-matching motion complexity.

The reference's motion metric is the mean Farneback optical-flow magnitude
between sampled frame pairs at full resolution
(``complexity_metrics.py:313-343``). Farneback's iterative polynomial
expansion is a poor fit for batched device code; per the BASELINE.md north
star the framework substitutes **block matching** — a documented behavioral
substitution (SURVEY.md §2 native-component table, hard part 5):

* partition the current frame into ``block x block`` tiles;
* for each tile, find the integer displacement within ``±radius`` minimizing
  SAD against the previous frame (replicate-padded at borders);
* the metric is the mean displacement magnitude over tiles — same units as
  mean flow magnitude (pixels per sampled-frame step).

Two search modes (``docs/PARITY.md`` §motion):

* **full** (``block_match_motion``): exhaustive over all (2r+1)^2 candidate
  displacements at full resolution;
* **pyramid** (``block_match_motion_pyramid``, the production default):
  2x2-mean downsample, exhaustive search at half resolution with
  block/2, radius/2, displacement magnitudes scaled by 2. Covers the SAME
  ±radius full-resolution span at ~1/14 the arithmetic (candidates /3.6,
  pixels /4), quantized to even displacements — the closest analog of the
  reference Farneback's own pyramid (its defaults are 3 levels, pyr_scale
  0.5, ``complexity_metrics.py:336-340``).

Implementation: on the GPU, a search kernel
(``kernels.motion_triton.block_match_field_triton``) that loads each tile
once and walks every candidate in registers; elsewhere one ``lax.scan`` over
the (2r+1)^2 candidate displacements. Each scan step is a dynamic-slice of
the padded previous frame + an elementwise SAD + a blockwise sum
(reshape-reduce) — fully static shapes, everything batched over frames.
Running argmin keeps (best_sad, best_dy, best_dx). ``backend.on_gpu`` is the
one choice between them.

Scale note: ties are broken toward the smaller raster-scan candidate index
(first minimum wins), so static scenes report exactly 0.0 in both modes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.backend import on_gpu


def block_match_field(
    prev_gray: jnp.ndarray,
    curr_gray: jnp.ndarray,
    block: int = 16,
    radius: int = 8,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exhaustive block-matching displacement FIELD: (..., H, W) ->
    ((..., nby, nbx) dy, (..., nbx) dx) float32 — first (raster-order)
    minimum wins. Shared by the mean-magnitude metric and the two-level
    pyramid's coarse pass."""
    h, w = curr_gray.shape[-2], curr_gray.shape[-1]
    hb, wb = (h // block) * block, (w // block) * block
    curr = curr_gray[..., :hb, :wb].astype(jnp.float32)
    prev = prev_gray[..., :hb, :wb].astype(jnp.float32)

    pad = [(0, 0)] * (prev.ndim - 2) + [(radius, radius), (radius, radius)]
    prev_p = jnp.pad(prev, pad, mode="edge")

    lead = curr.shape[:-2]
    nby, nbx = hb // block, wb // block

    def block_sad(shifted_prev):
        d = jnp.abs(curr - shifted_prev)
        d = d.reshape(*lead, nby, block, nbx, block)
        return jnp.sum(d, axis=(-3, -1))  # (..., nby, nbx)

    side = 2 * radius + 1
    dys, dxs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    candidates = jnp.asarray(
        np.stack([dys.ravel(), dxs.ravel()], axis=-1), dtype=jnp.int32
    )

    big = jnp.full((*lead, nby, nbx), jnp.inf, dtype=jnp.float32)
    zero = jnp.zeros((*lead, nby, nbx), dtype=jnp.float32)

    def step(carry, disp):
        best_sad, best_dy, best_dx = carry
        dy, dx = disp[0], disp[1]
        start = (0,) * len(lead) + (dy, dx)
        shifted = jax.lax.dynamic_slice(prev_p, start, curr.shape)
        sad = block_sad(shifted)
        better = sad < best_sad  # strict: first (raster-order) minimum wins
        fdy = (dy - radius).astype(jnp.float32)
        fdx = (dx - radius).astype(jnp.float32)
        best_sad = jnp.where(better, sad, best_sad)
        best_dy = jnp.where(better, fdy, best_dy)
        best_dx = jnp.where(better, fdx, best_dx)
        return (best_sad, best_dy, best_dx), None

    (_, best_dy, best_dx), _ = jax.lax.scan(
        step, (big, zero, zero), candidates
    )
    return best_dy, best_dx


def block_match_motion(
    prev_gray: jnp.ndarray,
    curr_gray: jnp.ndarray,
    block: int = 16,
    radius: int = 8,
) -> jnp.ndarray:
    """Mean block displacement magnitude per pair: (..., H, W) -> (...,).

    H, W are cropped down to multiples of ``block`` (cv2's Farneback also
    effectively ignores sub-block remainders at the border).
    """
    if on_gpu():
        from rtvqa_tpu.kernels.motion_triton import block_match_field_triton

        field = block_match_field_triton
    else:
        field = block_match_field
    best_dy, best_dx = field(prev_gray, curr_gray, block, radius)
    mag = jnp.sqrt(best_dy * best_dy + best_dx * best_dx)
    return jnp.mean(mag, axis=(-2, -1))


def down2_mean(x: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean pooling (..., H, W) -> (..., H//2, W//2); odd tails cropped.

    BITWISE equal to the reshape-reduce form and to the NumPy oracle: the
    sum of four u8-derived f32 values is exact and 0.25 is a power-of-two
    scale, so the pyramid's argmin ties cannot flip between forms.
    """
    h = (x.shape[-2] // 2) * 2
    w = (x.shape[-1] // 2) * 2
    xc = x[..., :h, :w].astype(jnp.float32)
    window = (1,) * (xc.ndim - 2) + (2, 2)
    return 0.25 * jax.lax.reduce_window(
        xc, 0.0, jax.lax.add, window, window, "VALID"
    )


def block_match_motion_pyramid(
    prev_gray: jnp.ndarray,
    curr_gray: jnp.ndarray,
    block: int = 16,
    radius: int = 8,
) -> jnp.ndarray:
    """Pyramid (coarse-level) block-matching motion: (..., H, W) -> (...,).

    Downsample 2x (mean pool), exhaustive search with block/2 and radius/2,
    displacement magnitudes scaled back by 2 — the same spatial blocks and
    the same ±radius search span as the full search, at ~1/14 the
    arithmetic (see module docstring).
    """
    bp = max(block // 2, 1)
    rp = max(radius // 2, 1)
    pg = down2_mean(prev_gray)
    cg = down2_mean(curr_gray)
    return 2.0 * block_match_motion(pg, cg, block=bp, radius=rp)


def block_match_motion_pyramid_series(
    gray_series: jnp.ndarray,
    block: int = 16,
    radius: int = 8,
) -> jnp.ndarray:
    """Pyramid motion over consecutive pairs of one frame series:
    (N, H, W) -> (N-1,).

    Equivalent to ``block_match_motion_pyramid(g[:-1], g[1:])`` but pools the
    series ONCE — the pairwise form pays the memory-bound 2x2 pooling twice
    on 99%-overlapping slices (frame-axis slicing commutes with spatial
    pooling).
    """
    bp = max(block // 2, 1)
    rp = max(radius // 2, 1)
    gh = down2_mean(gray_series)
    return 2.0 * block_match_motion(gh[:-1], gh[1:], block=bp, radius=rp)


def block_match_motion_pyramid2_series(
    gray_series: jnp.ndarray,
    block: int = 16,
    radius: int = 8,
) -> jnp.ndarray:
    """TWO-level pyramid motion (VERDICT r3 next #3 experiment): quarter-res
    exhaustive coarse search + half-res ±1 refinement around the per-block
    coarse vector. (N, H, W) -> (N-1,).

    The reference Farneback defaults to a 3-level pyramid
    (``complexity_metrics.py:336-340``); this is its 2-coarse-level analog:
    coarse covers the same ±radius full-res span at 1/16 the pixels x 25
    candidates, refinement restores half-res (even full-res) displacement
    quantization — the same quantization as the production single-level
    pyramid. The refinement prev-image is built by a 25-way masked select of
    coarse-shifted slices (no gathers, static shapes).

    **Measured dead end — NOT production** (round 4): on both textured and
    smooth-periodic content, a half-quarter-pixel true shift makes the
    quarter-res SAD landscape ambiguous, the tiny (block/4)^2 coarse blocks
    argmin essentially at random within ±rq, and ±1 refinement cannot
    recover from a wrong coarse vector — the metric drifts ~1.7x from truth
    where the single-level pyramid is EXACT
    (tests/test_complexity_ops.py::test_pyramid2_documented_failure_mode).
    The value drift disqualifies the scheme before any perf measurement.
    Kept as the committed record of the experiment.
    """
    bp = max(block // 2, 1)
    rp = max(radius // 2, 1)
    bq = max(bp // 2, 1)
    rq = max(rp // 2, 1)
    gh = down2_mean(gray_series)          # half res
    gq = down2_mean(gh)                   # quarter res

    cdy, cdx = block_match_field(gq[:-1], gq[1:], block=bq, radius=rq)

    # Crop half-res to the block grid the quarter field describes.
    nby, nbx = cdy.shape[-2], cdy.shape[-1]
    hb, wb = nby * bp, nbx * bp
    prev_h = gh[:-1, :hb, :wb]
    curr_h = gh[1:, :hb, :wb]

    # Selected prev: each block shifted by its coarse vector (x2 on the
    # half-res grid), built as a 25-way masked sum of uniformly shifted
    # slices — no data-dependent gathers.
    pad_r = 2 * rq + 1  # max |2c| + refinement halo 1
    prev_p = jnp.pad(
        prev_h, ((0, 0), (pad_r, pad_r), (pad_r, pad_r)), mode="edge"
    )
    acc = jnp.zeros_like(prev_h)
    for cy in range(-rq, rq + 1):
        for cx in range(-rq, rq + 1):
            m = (cdy == cy) & (cdx == cx)                 # (N-1, nby, nbx)
            mpix = jnp.broadcast_to(
                m[:, :, None, :, None],
                (m.shape[0], nby, bp, nbx, bp),
            ).reshape(m.shape[0], hb, wb)
            sl = jax.lax.dynamic_slice(
                prev_p, (0, pad_r + 2 * cy, pad_r + 2 * cx), prev_h.shape
            )
            acc = acc + jnp.where(mpix, sl, 0.0)

    ody, odx = block_match_field(acc, curr_h, block=bp, radius=1)
    fdy = 2.0 * cdy + ody
    fdx = 2.0 * cdx + odx
    mag = jnp.sqrt(fdy * fdy + fdx * fdx)
    return 2.0 * jnp.mean(mag, axis=(-2, -1))


def fps_variation(timestamps_ms: jnp.ndarray, valid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Instantaneous fps ``1/dt`` per consecutive sampled-timestamp pair.

    Matches ``process_frame_interval_for_parallel``
    (``complexity_metrics.py:150-165``): nonpositive dt -> 0.0. Input is the
    (possibly padded) (..., N) timestamp vector in milliseconds with a
    validity mask; returns ((..., N-1) fps values, (..., N-1) pair validity).
    """
    ts = timestamps_ms.astype(jnp.float32)
    dt = (ts[..., 1:] - ts[..., :-1]) / 1000.0
    fps = jnp.where(dt > 0, 1.0 / jnp.maximum(dt, 1e-9), 0.0)
    pair_valid = valid[..., 1:] & valid[..., :-1]
    return fps * pair_valid.astype(fps.dtype), pair_valid
