"""Edge-detection ops: Sobel gradients, Canny-style edge maps, edge counts.

Reference: ``process_edge_frame`` (``complexity_metrics.py:477-504``) runs
``cv2.Canny(gray, 100, 200)`` on the resized gray frame and returns the raw
count of edge pixels.

On-device design: a full Canny pipeline with static shapes —

1. 3x3 Sobel gradients (replicate border), L1 magnitude (cv2 default
   ``L2gradient=False``);
2. non-maximum suppression via the cv2 sector rule (tan 22.5° / tan 67.5°
   comparisons, one strict / one non-strict neighbor test);
3. double threshold + hysteresis as an iterated 8-connected dilation under a
   ``lax.while_loop`` fixed point (edge propagation distance is
   data-dependent; the loop carries a "changed" flag, all shapes static).

``sobel_edge_density`` is the cheap single-threshold variant (the BASELINE.md
north star's documented Sobel substitution) used by throughput-oriented modes.
The analyzer default is the Canny path for behavioral parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_TG22 = 0.4142135623730951  # tan(22.5 deg)
_TG67 = 2.414213562373095   # tan(67.5 deg)


def _replicate_pad(x: jnp.ndarray, p: int = 1) -> jnp.ndarray:
    return jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(p, p), (p, p)], mode="edge")


def _shift(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Value of the neighbor at (+dy, +dx), replicate border, same shape."""
    h, w = x.shape[-2], x.shape[-1]
    p = _replicate_pad(x, 1)
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def sobel_gradients(gray: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel gx, gy over (..., H, W) with replicate border (cv2 default).

    Stencil evaluated as 8 shifted adds — XLA fuses these into one pass;
    no convolution op needed for a fixed 3x3 kernel.
    """
    g = gray.astype(jnp.float32)
    tl, t, tr = _shift(g, -1, -1), _shift(g, -1, 0), _shift(g, -1, 1)
    l, r = _shift(g, 0, -1), _shift(g, 0, 1)
    bl, b, br = _shift(g, 1, -1), _shift(g, 1, 0), _shift(g, 1, 1)
    gx = (tr + 2.0 * r + br) - (tl + 2.0 * l + bl)
    gy = (bl + 2.0 * b + br) - (tl + 2.0 * t + tr)
    return gx, gy


def canny_edges(
    gray: jnp.ndarray,
    low: float = 100.0,
    high: float = 200.0,
    max_hysteresis_iters: int | None = None,
) -> jnp.ndarray:
    """Canny edge map over (..., H, W) -> bool (..., H, W).

    Follows cv2.Canny's structure (L1 magnitude, sector-based NMS with
    strict/non-strict neighbor comparisons, 8-connected hysteresis). The
    hysteresis fixed point is reached via ``lax.while_loop``; each dilation
    round extends edge chains by one pixel and the loop exits early once
    converged. The safety cap defaults to H*W — a true upper bound (every
    non-final round marks at least one new pixel), so the fixed point is
    always reached exactly at any resolution; cost stays data-dependent
    (geodesic chain length) thanks to the early exit, and the cap is a
    compile-time constant since shapes are static at trace time.
    """
    if max_hysteresis_iters is None:
        max_hysteresis_iters = gray.shape[-2] * gray.shape[-1]
    gx, gy = sobel_gradients(gray)
    mag = jnp.abs(gx) + jnp.abs(gy)

    ax, ay = jnp.abs(gx), jnp.abs(gy)
    horiz = ay <= _TG22 * ax
    vert = ay >= _TG67 * ax
    diag = ~(horiz | vert)
    same_sign = (gx * gy) >= 0

    def nbrs(dy, dx):
        return _shift(mag, dy, dx), _shift(mag, -dy, -dx)

    h1, h2 = nbrs(0, 1)
    v1, v2 = nbrs(1, 0)
    d1a, d1b = nbrs(1, 1)    # gradient along main diagonal
    d2a, d2b = nbrs(1, -1)   # gradient along anti-diagonal
    keep_h = (mag > h1) & (mag >= h2)
    keep_v = (mag > v1) & (mag >= v2)
    keep_d1 = (mag > d1a) & (mag >= d1b)
    keep_d2 = (mag > d2a) & (mag >= d2b)
    keep = (
        (horiz & keep_h)
        | (vert & keep_v)
        | (diag & jnp.where(same_sign, keep_d1, keep_d2))
    )

    nms = jnp.where(keep, mag, 0.0)
    strong = nms > high
    weak = nms > low

    def dilate8(m):
        out = m
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    out = out | _shift_bool(m, dy, dx)
        return out

    def _shift_bool(m, dy, dx):
        h, w = m.shape[-2], m.shape[-1]
        p = jnp.pad(m, [(0, 0)] * (m.ndim - 2) + [(1, 1), (1, 1)])
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    def cond(state):
        _, changed, it = state
        return changed & (it < max_hysteresis_iters)

    def body(state):
        cur, _, it = state
        grown = weak & dilate8(cur)
        nxt = cur | grown
        return nxt, jnp.any(nxt != cur), it + 1

    final, _, _ = jax.lax.while_loop(cond, body, (strong, jnp.bool_(True), 0))
    return final


def canny_edge_count(gray: jnp.ndarray, low: float = 100.0, high: float = 200.0) -> jnp.ndarray:
    """Per-frame count of Canny edge pixels over (..., H, W) — the reference's
    edge-complexity value (``complexity_metrics.py:503-504``)."""
    return jnp.sum(canny_edges(gray, low, high), axis=(-2, -1)).astype(jnp.float32)


def sobel_edge_density(gray: jnp.ndarray, threshold: float = 200.0) -> jnp.ndarray:
    """Cheap edge count: L1 Sobel magnitude > threshold (north-star Sobel
    substitution; single elementwise pass, no NMS/hysteresis)."""
    gx, gy = sobel_gradients(gray)
    return jnp.sum((jnp.abs(gx) + jnp.abs(gy)) > threshold, axis=(-2, -1)).astype(jnp.float32)
