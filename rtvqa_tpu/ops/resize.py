"""Bilinear resize as separable matmuls.

The reference resizes every frame on the host with ``cv2.resize`` default
``INTER_LINEAR`` (``complexity_metrics.py:359, 379, 405, 431, 491, 530``).
Geometry: half-pixel centers, ``src = (dst + 0.5) * scale - 0.5``, clamped, no
antialiasing. A separable bilinear resize is exactly a pair of dense
contractions ``R_h @ X @ R_w^T`` with precomputed (static-shape) weight
matrices — real linear maps onto small outputs, pinned to ``HIGHEST``
precision so an f32 product never runs in TF32.

Note this is *not* ``jax.image.resize`` semantics: that antialiases on
downscale by default; cv2 does not. The weight matrices are built at trace
time from static shapes and get baked into the executable as constants.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) row-stochastic bilinear interpolation matrix, cv2 geometry."""
    m = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), src - 1)
        hi = min(max(x0 + 1, 0), src - 1)
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    m.setflags(write=False)  # lru_cached: callers must not mutate (ADVICE r3)
    return m


def resize_bilinear(x: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Resize (..., H, W) float array to (..., out_h, out_w), cv2 INTER_LINEAR
    geometry (no antialias). Runs as two f32 contractions."""
    h, w = x.shape[-2], x.shape[-1]
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    if h != out_h:
        rh = jnp.asarray(_bilinear_matrix(out_h, h), dtype=dtype)
        x = jnp.einsum("oh,...hw->...ow", rh, x, preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST)
    if w != out_w:
        rw = jnp.asarray(_bilinear_matrix(out_w, w), dtype=dtype)
        x = jnp.einsum("pw,...hw->...hp", rw, x, preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST)
    return x


@functools.lru_cache(maxsize=64)
def bilinear_sample_plan(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """(row-index vector, compact weight matrix) for a gathered bilinear
    contraction: ``_bilinear_matrix(dst, src)`` has <=2 nonzero taps per
    output, so for heavy downscales (1080 -> 64) the dense contraction reads
    the whole source while only ``<= 2*dst`` rows carry weight. Returns
    ``idx`` (k,) int32 of the distinct source rows used and ``mat`` (dst, k)
    with ``mat @ x[idx] == _bilinear_matrix(dst, src) @ x`` BITWISE (the
    dropped terms are exact zeros; f32 addition of 0.0 is exact)."""
    m = _bilinear_matrix(dst, src)
    idx = np.unique(np.nonzero(m)[1]).astype(np.int32)
    mat = np.ascontiguousarray(m[:, idx])
    # lru_cached: freeze so a mutating caller can't corrupt later calls.
    idx.setflags(write=False)
    mat.setflags(write=False)
    return idx, mat


def resize_bilinear_sampled(x: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bitwise-equal to :func:`resize_bilinear`, but gathers the needed
    source ROWS before the row contraction (``bilinear_sample_plan``) —
    reads ``2*out_h/H`` of the input instead of all of it. The column pass
    stays a dense matmul on the already-row-reduced array (a lane gather
    would relayout; the row-reduced operand is small).

    When to use: only when the gather removes UPSTREAM work (e.g. the color
    path converts+clips just the gathered rows); for a plain f32 array
    already on the device use :func:`resize_bilinear`."""
    h, w = x.shape[-2], x.shape[-1]
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    if h != out_h:
        idx, mat = bilinear_sample_plan(out_h, h)
        x = jnp.take(x, jnp.asarray(idx), axis=-2)
        x = jnp.einsum(
            "oh,...hw->...ow", jnp.asarray(mat, dtype), x,
            preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST,
        )
    return resize_bilinear(x, out_h, out_w)


def resize_bilinear_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """NumPy oracle with identical geometry (float path of cv2.resize)."""
    x = x.astype(np.float64)
    h, w = x.shape[-2], x.shape[-1]
    rh = _bilinear_matrix(out_h, h).astype(np.float64)
    rw = _bilinear_matrix(out_w, w).astype(np.float64)
    y = np.einsum("oh,...hw->...ow", rh, x)
    return np.einsum("pw,...hw->...hp", rw, y)
