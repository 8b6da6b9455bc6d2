"""Separable filtering primitives for the VMAF feature extractors.

All VMAF features are built on 1D separable convolutions over the luma plane
(Gaussian windows for VIF, a 5-tap blur for motion, db2 wavelet taps for
ADM). The JAX path evaluates them as k statically-shifted scaled adds over
reflect-padded inputs, which XLA fuses into elementwise passes (a dense
band-matrix matmul would burn ~64x the FLOPs at 1080p). Border mode is mirrored reflection
without edge repetition (scipy 'mirror', matching libvmaf's vif_filter1d),
implemented via ``jnp.pad(mode='reflect')``.

The NumPy oracles intentionally use an independent dense band-matrix
construction (``_conv_matrix``) so JAX/oracle agreement is meaningful.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """Symmetric normalized Gaussian window of ``n`` taps (libvmaf VIF form)."""
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


def _conv_1d(x: jnp.ndarray, taps: np.ndarray, axis: int, mode: str) -> jnp.ndarray:
    """1D correlation along trailing axis -1 or -2 with border handling.

    Evaluated as k statically-shifted scaled adds over the padded array —
    XLA fuses the chain into elementwise passes.
    """
    assert axis in (-1, -2)
    taps_a = np.asarray(taps, dtype=np.float32)
    k = len(taps_a)
    half = k // 2
    pad_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    pad_width = [(0, 0)] * (x.ndim - 2) + (
        [(half, k - 1 - half), (0, 0)] if axis == -2 else [(0, 0), (half, k - 1 - half)]
    )
    xp = jnp.pad(x.astype(jnp.float32), pad_width, mode=pad_mode)

    h, w = x.shape[-2], x.shape[-1]
    acc = None
    for t in range(k):
        if axis == -2:
            sl = xp[..., t : t + h, :]
        else:
            sl = xp[..., :, t : t + w]
        term = float(taps_a[t]) * sl
        acc = term if acc is None else acc + term
    return acc


def filter1d_sep(
    x: jnp.ndarray, taps: np.ndarray, mode: str = "reflect"
) -> jnp.ndarray:
    """Separable 2D filter over trailing (H, W) axes (rows then columns)."""
    return _conv_1d(_conv_1d(x, taps, -2, mode), taps, -1, mode)


def filter1d_sep_axis(
    x: jnp.ndarray, taps: np.ndarray, axis: int, mode: str = "reflect"
) -> jnp.ndarray:
    """1D convolution along one of the trailing two axes (reflect borders)."""
    return _conv_1d(x, taps, axis, mode)


def even_lanes(x: jnp.ndarray) -> jnp.ndarray:
    """Keep the even indices of the LAST axis (libvmaf-style decimation).

    An odd width is zero-padded by one, split into (width/2, 2) pairs, and
    the first of each pair is kept: the elements of ``x[..., ::2]``. With
    the strided slice itself, XLA:CPU sums VIF scale 2's statistics in an
    order that depends on the batch size (7e-7 apart between one frame and
    eight), which breaks the bit-equality of the sharded and single-device
    chunk programs; this form keeps them equal.
    """
    w = x.shape[-1]
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, w % 2)])
    return x.reshape(*x.shape[:-1], (w + 1) // 2, 2)[..., 0]


def decimate2(x: jnp.ndarray) -> jnp.ndarray:
    """Subsample trailing (H, W) by 2 (keep even indices, libvmaf style).

    Rows by a strided slice, columns by ``even_lanes``: decimating both
    axes in one reshape makes XLA:CPU's VIF scale 1 differ between uint8
    and f32 inputs (2e-7).
    """
    return even_lanes(x[..., ::2, :])


# --- NumPy oracles (independent dense band-matrix construction) ------------


@functools.lru_cache(maxsize=256)
def _conv_matrix(length: int, taps: tuple, mode: str) -> np.ndarray:
    """(length, length) matrix equal to 1D convolution with border handling.

    ``mode``: 'reflect' mirrors without repeating the edge sample (scipy
    'mirror' / libvmaf's vif_filter1d border handling).
    """
    taps_a = np.asarray(taps, dtype=np.float64)
    n = len(taps_a)
    half = n // 2
    m = np.zeros((length, length), dtype=np.float64)
    for i in range(length):
        for t in range(n):
            j = i + t - half
            if mode == "reflect":
                if j < 0:
                    j = -j
                elif j >= length:
                    j = 2 * length - 2 - j
                j = int(np.clip(j, 0, length - 1))
            elif mode == "edge":
                j = int(np.clip(j, 0, length - 1))
            else:
                raise ValueError(mode)
            m[i, j] += taps_a[t]
    return m


def filter1d_sep_np(x: np.ndarray, taps: np.ndarray, mode: str = "reflect") -> np.ndarray:
    h, w = x.shape[-2], x.shape[-1]
    t = tuple(float(v) for v in np.asarray(taps, dtype=np.float64))
    mh = _conv_matrix(h, t, mode)
    mw = _conv_matrix(w, t, mode)
    return (mh @ x.astype(np.float64)) @ mw.T


def filter1d_sep_axis_np(x: np.ndarray, taps: np.ndarray, axis: int, mode: str = "reflect") -> np.ndarray:
    assert axis in (-1, -2)
    length = x.shape[axis]
    t = tuple(float(v) for v in np.asarray(taps, dtype=np.float64))
    m = _conv_matrix(length, t, mode)
    x = x.astype(np.float64)
    return m @ x if axis == -2 else x @ m.T
