"""ORB-style FAST+BRIEF keypoint stage with fully static shapes.

Reference: ``process_orb_frame_for_parallel`` (``complexity_metrics.py:
367-389``) resizes the frame to a hard-coded 64x64 (ignoring config dims,
SURVEY.md §2.4(6) — replicated deliberately, since the metric's scale depends
on it), runs ``cv2.ORB_create().detectAndCompute`` and returns the keypoint
*count*.

On-device design (SURVEY.md §7 hard part 2 — data-dependent keypoint counts
vs XLA static shapes):

* **FAST-9/16 detection** as a dense map: the 16 Bresenham-circle samples are
  16 static shifts; "≥9 contiguous brighter/darker" evaluates as an OR over
  the 16 rotations of an AND over 9 consecutive flags — pure elementwise
  boolean algebra, no data-dependent shapes anywhere.
* **corner score** = the classic FAST score (max threshold at which the pixel
  stays a corner): max over the 16 arcs of the min signed contrast along the
  arc.
* **3x3 non-max suppression** on the score map (OpenCV FAST
  ``nonmaxSuppression=True`` behaviour).
* **image pyramid** (``nlevels`` levels, factor ``scaleFactor``) with
  per-level static shapes computed at trace time; border keypoints within
  ``edge_threshold`` are masked out (this is what makes the reference's
  64x64 counts tiny: 64 - 2*31 leaves a 2x2 valid zone on level 0 only).
* the metric output is a **masked count** capped at ``nfeatures`` — shapes
  never depend on data.
* **descriptors**: a fixed-K stage — ``top_k`` over the flattened score map
  gives static (K,) keypoints; orientation by intensity centroid (radius-3
  patch) and a 256-bit BRIEF descriptor from a fixed seeded sampling pattern
  (classic BRIEF's random-pair construction; OpenCV's learned rBRIEF pattern
  is approximated, documented divergence).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.ops.resize import resize_bilinear

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx) —
# the standard FAST-16 ring.
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring_samples(gray: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (16, ..., H, W) circle samples (zero-padded border;
    border pixels are masked out of detection anyway)."""
    h, w = gray.shape[-2], gray.shape[-1]
    pad = [(0, 0)] * (gray.ndim - 2) + [(3, 3), (3, 3)]
    g = jnp.pad(gray, pad)
    return jnp.stack(
        [g[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in CIRCLE16],
        axis=0,
    )


def fast_score(gray: jnp.ndarray, threshold: float = 20.0) -> jnp.ndarray:
    """Dense FAST-9/16 corner-score map over (..., H, W); 0 = not a corner.

    Score = max over the 16 length-9 arcs of the minimum contrast along the
    arc (bright arcs use ``ring - center``, dark arcs ``center - ring``);
    a pixel is a corner iff score > threshold.
    """
    g = gray.astype(jnp.float32)
    ring = _ring_samples(g)  # (16, ..., H, W)
    bright = ring - g[None]
    dark = -bright

    def arc_score(diffs):
        # min over each 9-long contiguous arc, then max over the 16 arcs.
        best = None
        for start in range(16):
            idx = [(start + k) % 16 for k in range(9)]
            arc_min = diffs[idx[0]]
            for i in idx[1:]:
                arc_min = jnp.minimum(arc_min, diffs[i])
            best = arc_min if best is None else jnp.maximum(best, arc_min)
        return best

    score = jnp.maximum(arc_score(bright), arc_score(dark))
    # Mask the 3px ring border (samples there wrapped into padding).
    h, w = g.shape[-2], g.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    score = jnp.where(interior, score, 0.0)
    return jnp.where(score > threshold, score, 0.0)


def _nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep strict local maxima of the score map in their 3x3 neighborhood."""
    h, w = score.shape[-2], score.shape[-1]
    pad = [(0, 0)] * (score.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(score, pad, constant_values=-jnp.inf)
    neigh_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            neigh_max = s if neigh_max is None else jnp.maximum(neigh_max, s)
    return jnp.where(score > neigh_max, score, 0.0)


def fast_keypoint_map(
    gray: jnp.ndarray, threshold: float = 20.0, edge_threshold: int = 31
) -> jnp.ndarray:
    """NMS'd FAST score map with the ORB edge border masked out."""
    score = _nms3x3(fast_score(gray, threshold))
    h, w = gray.shape[-2], gray.shape[-1]
    if 2 * edge_threshold >= min(h, w):
        return jnp.zeros_like(score)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (
        (ys >= edge_threshold)
        & (ys < h - edge_threshold)
        & (xs >= edge_threshold)
        & (xs < w - edge_threshold)
    )
    return jnp.where(inside, score, 0.0)


@functools.lru_cache(maxsize=8)
def pyramid_shapes(h: int, w: int, nlevels: int, scale_factor: float) -> tuple:
    """Static per-level (h, w) like OpenCV ORB's rounded pyramid sizes."""
    shapes = []
    for lvl in range(nlevels):
        s = scale_factor ** lvl
        shapes.append((max(1, int(round(h / s))), max(1, int(round(w / s)))))
    return tuple(shapes)


def orb_keypoint_count(
    gray: jnp.ndarray,
    nfeatures: int = 500,
    nlevels: int = 8,
    scale_factor: float = 1.2,
    edge_threshold: int = 31,
    fast_threshold: float = 20.0,
) -> jnp.ndarray:
    """Per-frame ORB keypoint count over (..., H, W), capped at ``nfeatures``.

    Counts NMS'd FAST-9 corners across the image pyramid inside the ORB
    border — the quantity ``len(keypoints)`` the reference consumes
    (``complexity_metrics.py:389``). Harris re-ranking (cv2's retention
    tie-breaker) is irrelevant to the count until the cap binds and is
    applied here only as the cap itself.
    """
    h, w = gray.shape[-2], gray.shape[-1]
    total = None
    for lh, lw in pyramid_shapes(h, w, nlevels, scale_factor):
        level = gray if (lh, lw) == (h, w) else resize_bilinear(gray, lh, lw)
        kmap = fast_keypoint_map(level, fast_threshold, edge_threshold)
        cnt = jnp.sum(kmap > 0, axis=(-2, -1)).astype(jnp.float32)
        total = cnt if total is None else total + cnt
    return jnp.minimum(total, float(nfeatures))


# --- fixed-K keypoint extraction + BRIEF descriptors -----------------------


def harris_response(
    gray: jnp.ndarray, block_size: int = 7, k: float = 0.04
) -> jnp.ndarray:
    """Dense Harris corner response over (..., H, W).

    cv2 ORB ranks keypoints for retention by Harris response over a 7x7
    block around each corner (``HARRIS_SCORE``, the default), computed from
    first derivatives: R = det(M) - k*trace(M)^2 with M the block-summed
    structure tensor. Derivatives here are 3x3 Sobel (cv2's HarrisResponses
    uses a plain central difference; the ranking they induce agrees on
    corner-vs-edge ordering — documented approximation, docs/PARITY.md).
    Evaluated densely as shifted adds: static shapes, one elementwise pass.
    """
    from rtvqa_tpu.ops.edges import sobel_gradients

    gx, gy = sobel_gradients(gray)
    ixx, iyy, ixy = gx * gx, gy * gy, gx * gy
    r = block_size // 2

    def box_sum(x):
        # Separable block_size x block_size box sum, zero-padded borders.
        h, w = x.shape[-2], x.shape[-1]
        pad = [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)]
        p = jnp.pad(x, pad)
        rows = sum(p[..., i : i + h, r : r + w] for i in range(block_size))
        pr = jnp.pad(rows, [(0, 0)] * (x.ndim - 2) + [(0, 0), (r, r)])
        return sum(pr[..., :, j : j + w] for j in range(block_size))

    sxx, syy, sxy = box_sum(ixx), box_sum(iyy), box_sum(ixy)
    # Normalize like cv2 (scale = 1/(4*blockSize*255), applied squared to the
    # products): keeps responses in a comparable range across block sizes.
    scale_sq = (1.0 / (4 * block_size * 255.0)) ** 2
    sxx, syy, sxy = sxx * scale_sq, syy * scale_sq, sxy * scale_sq
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


@functools.lru_cache(maxsize=4)
def _brief_pattern(n_bits: int = 256, patch: int = 24, seed: int = 7) -> np.ndarray:
    """(n_bits, 4) int32 sampling pairs (y1,x1,y2,x2), Gaussian BRIEF style."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    pts = np.clip(
        np.rint(rng.normal(0.0, sigma, size=(n_bits, 4))), -(patch // 2), patch // 2
    ).astype(np.int32)
    return pts


def orb_features(
    gray: jnp.ndarray,
    k: int = 500,
    fast_threshold: float = 20.0,
    edge_threshold: int = 31,
    n_bits: int = 256,
) -> dict[str, jnp.ndarray]:
    """Fixed-K keypoints + orientations + BRIEF-256 descriptors, (B, H, W) in.

    When more than K corners exist, retention follows cv2 ORB's default
    ``HARRIS_SCORE`` policy: detected FAST corners are ranked by Harris
    response and the best K are kept (``KeyPointsFilter::retainBest``; the
    reference buys this behavior at ``complexity_metrics.py:378,385``).

    Returns dict with ``ys, xs (B,K) int32``, ``score (B,K)`` (Harris
    response), ``fast_score (B,K)``, ``valid (B,K) bool``, ``angle (B,K)``
    radians, ``desc (B,K,n_bits) bool``. K is static; invalid slots (fewer
    than K detected corners) are masked.
    """
    b, h, w = gray.shape
    kmap = fast_keypoint_map(gray, fast_threshold, edge_threshold)
    harris = harris_response(gray)
    rank = jnp.where(kmap > 0, harris, -jnp.inf).reshape(b, h * w)
    score, idx = jax.lax.top_k(rank, k)
    valid = jnp.isfinite(score)
    score = jnp.where(valid, score, 0.0)
    ys = idx // w
    xs = idx % w
    fast_sc = jnp.take_along_axis(kmap.reshape(b, h * w), idx, axis=1)

    g = gray.astype(jnp.float32)

    # Orientation: intensity centroid over a (2r+1)^2 patch, r=3.
    r = 3
    m01 = jnp.zeros((b, k), jnp.float32)
    m10 = jnp.zeros((b, k), jnp.float32)
    gp = jnp.pad(g, ((0, 0), (r, r), (r, r)))

    def patch_at(dy, dx):
        yy = jnp.clip(ys + dy + r, 0, h + 2 * r - 1)
        xx = jnp.clip(xs + dx + r, 0, w + 2 * r - 1)
        batch = jnp.arange(b, dtype=jnp.int32)[:, None]
        return gp[batch, yy, xx]

    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            val = patch_at(dy, dx)
            m01 = m01 + dy * val
            m10 = m10 + dx * val
    angle = jnp.arctan2(m01, m10)

    # Steered BRIEF: rotate the sampling pattern by the keypoint angle.
    pat = jnp.asarray(_brief_pattern(n_bits), dtype=jnp.float32)  # (n_bits, 4)
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (B, K)

    def rot(y, x):
        # (n_bits,) pattern offsets rotated per-keypoint -> (B, K, n_bits)
        ry = y[None, None, :] * ca[..., None] + x[None, None, :] * sa[..., None]
        rx = -y[None, None, :] * sa[..., None] + x[None, None, :] * ca[..., None]
        return jnp.rint(ry).astype(jnp.int32), jnp.rint(rx).astype(jnp.int32)

    y1, x1 = rot(pat[:, 0], pat[:, 1])
    y2, x2 = rot(pat[:, 2], pat[:, 3])

    def sample(yy_off, xx_off):
        yy = jnp.clip(ys[..., None] + yy_off, 0, h - 1)
        xx = jnp.clip(xs[..., None] + xx_off, 0, w - 1)
        batch = jnp.arange(b, dtype=jnp.int32)[:, None, None]
        return g[batch, yy, xx]

    desc = sample(y1, x1) < sample(y2, x2)
    return {
        "ys": ys, "xs": xs, "score": score, "fast_score": fast_sc,
        "valid": valid, "angle": angle, "desc": desc & valid[..., None],
    }
