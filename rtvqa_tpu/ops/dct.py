"""2D DCT ops as matmul chains.

The reference computes per-frame ``cv2.dct`` (orthonormal DCT-II) on the
resized gray frame and reduces it two ways:

* spatial energy: ``sum(dct ** 2)`` (``complexity_metrics.py:346-364``);
* temporal difference: ``sum(|dct(prev) - dct(curr)|)``
  (``complexity_metrics.py:543-579``, CPU path — the GPU path wrongly uses
  FFT, SURVEY.md §2.4(2), and is not replicated).

Device formulation: the 2D orthonormal DCT-II of ``X`` is ``D_h @ X @
D_w^T`` with precomputed basis matrices — two f32 matmuls pinned to
``HIGHEST`` precision, batched over frames with a single ``einsum``. Two mathematically exact rewrites are exploited:

* **Parseval**: the DCT is orthonormal, so ``sum(dct(x)**2) == sum(x**2)``.
  ``dct_energy`` therefore skips the transform entirely (verified against the
  explicit transform in tests).
* **Linearity**: ``dct(a) - dct(b) == dct(a - b)``, so the temporal metric
  needs ONE transform of the frame difference, not two.

Also provides the 8x8 blockwise DCT used by full-resolution analysis modes —
a (B, H/8, W/8, 8, 8) tiling followed by the same basis contraction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=16)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis, rows=frequencies (cv2.dct / scipy norm='ortho')."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float64)


def dct2(x: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal 2D DCT-II over the trailing two axes (cv2.dct semantics)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.astype(jnp.float32)
    dh = jnp.asarray(dct_matrix(h), dtype=jnp.float32)
    dw = jnp.asarray(dct_matrix(w), dtype=jnp.float32)
    y = jnp.einsum("kh,...hw->...kw", dh, x, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("lw,...kw->...kl", dw, y, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)


def dct_energy(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-frame DCT energy ``sum(dct2(gray)**2)`` over (..., H, W).

    Computed via Parseval as ``sum(gray**2)`` — exact, zero transforms.
    Matches ``process_dct_frame`` (``complexity_metrics.py:346-364``).
    """
    g = gray.astype(jnp.float32)
    return jnp.sum(g * g, axis=(-2, -1))


def temporal_dct_abs_diff(prev_gray: jnp.ndarray, curr_gray: jnp.ndarray) -> jnp.ndarray:
    """Per-pair ``sum(|dct2(prev) - dct2(curr)|)`` via DCT of the difference.

    Matches ``process_temporal_dct_frame`` CPU path
    (``complexity_metrics.py:574-578``).
    """
    diff = prev_gray.astype(jnp.float32) - curr_gray.astype(jnp.float32)
    return jnp.sum(jnp.abs(dct2(diff)), axis=(-2, -1))


def blockwise_dct8x8(x: jnp.ndarray) -> jnp.ndarray:
    """8x8 blockwise orthonormal DCT-II: (..., H, W) -> (..., H/8, W/8, 8, 8).

    H and W must be multiples of 8 (full-res analysis pads frames to 8-aligned
    shapes before calling). The per-block transform is a batched pair of
    (8,8) contractions — small matmuls that XLA batches.
    """
    h, w = x.shape[-2], x.shape[-1]
    assert h % 8 == 0 and w % 8 == 0, "blockwise DCT needs 8-aligned dims"
    lead = x.shape[:-2]
    x = x.astype(jnp.float32).reshape(*lead, h // 8, 8, w // 8, 8)
    x = jnp.swapaxes(x, -3, -2)  # (..., H/8, W/8, 8, 8)
    d = jnp.asarray(dct_matrix(8), dtype=jnp.float32)
    y = jnp.einsum("kh,...hw->...kw", d, x, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("lw,...kw->...kl", d, y, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)


# --- NumPy oracle ---


def dct2_np(x: np.ndarray) -> np.ndarray:
    """Reference implementation via explicit basis matrices (float64)."""
    h, w = x.shape[-2], x.shape[-1]
    dh, dw = dct_matrix(h), dct_matrix(w)
    return np.einsum("kh,...hw,lw->...kl", dh, x.astype(np.float64), dw)
