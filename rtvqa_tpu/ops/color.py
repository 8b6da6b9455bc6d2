"""Color-space conversion ops (device-side; JAX) + numpy mirrors for tests.

The reference decodes to interleaved BGR on the host via OpenCV and converts
to gray per frame with ``cv2.cvtColor`` (``complexity_metrics.py:332-333``
etc.). Here frames ship to the device as planar YUV420 (half the host→device
bytes of RGB) and conversion happens on the device, fused by XLA into
downstream kernels.

Conventions: BT.601 limited-range ("studio swing") YUV, the default
interpretation for untagged H.264 — matching what swscale/OpenCV assume when
converting yuv420p output to RGB. Gray uses the ITU-R BT.601 luma weights
(0.299, 0.587, 0.114), identical to ``cv2.COLOR_BGR2GRAY``. Chroma upsampling
is 2x2 nearest replication.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# BT.601 limited-range YUV -> full-range RGB.
_Y_SCALE = 255.0 / 219.0            # 1.1643835
_V_R = 255.0 / 224.0 * 1.402        # 1.5960267
_U_G = -255.0 / 224.0 * 0.344136    # -0.3917623
_V_G = -255.0 / 224.0 * 0.714136    # -0.8129676
_U_B = 255.0 / 224.0 * 1.772        # 2.0172321

GRAY_R, GRAY_G, GRAY_B = 0.299, 0.587, 0.114


def upsample_chroma(c: jnp.ndarray) -> jnp.ndarray:
    """(..., H/2, W/2) -> (..., H, W) by 2x2 nearest replication."""
    c = jnp.repeat(c, 2, axis=-2)
    c = jnp.repeat(c, 2, axis=-1)
    return c


def yuv_rows_to_rgb_planes(
    y_rows: jnp.ndarray, u_rows: jnp.ndarray, v_rows: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Row-aligned YUV -> (r, g, b) float32 planes in [0,255].

    ``y_rows`` (..., K, W) with ``u_rows``/``v_rows`` (..., K, W/2) already
    sampled at the MATCHING rows (caller maps luma row r to chroma row r//2 —
    the 2x row replication of :func:`upsample_chroma` expressed as an index);
    only the 2x LANE replication happens here. Lets callers that only need a
    few source rows (the 2-tap bilinear resize of the complexity color path)
    convert K rows instead of H — bitwise-identical values at the sampled
    positions.
    """
    yf = y_rows.astype(jnp.float32) - 16.0
    w = y_rows.shape[-1]
    uf = jnp.repeat(u_rows.astype(jnp.float32), 2, axis=-1)[..., :w] - 128.0
    vf = jnp.repeat(v_rows.astype(jnp.float32), 2, axis=-1)[..., :w] - 128.0
    r = _Y_SCALE * yf + _V_R * vf
    g = _Y_SCALE * yf + _U_G * uf + _V_G * vf
    b = _Y_SCALE * yf + _U_B * uf
    return (
        jnp.clip(r, 0.0, 255.0),
        jnp.clip(g, 0.0, 255.0),
        jnp.clip(b, 0.0, 255.0),
    )


def yuv420_to_rgb_planes(
    y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Planar YUV420 (limited range) -> three (..., H, W) float32 channel
    planes (r, g, b) in [0,255].

    Every step is elementwise over (..., H, W) arrays that XLA fuses into
    the consumer; the interleaved ``(..., H, W, 3)`` form would put the
    3-wide channel axis innermost.
    """
    u_rows = jnp.repeat(u, 2, axis=-2)[..., : y.shape[-2], :]
    v_rows = jnp.repeat(v, 2, axis=-2)[..., : y.shape[-2], :]
    return yuv_rows_to_rgb_planes(y, u_rows, v_rows)


def yuv420_to_rgb(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Planar YUV420 (limited range) -> (..., H, W, 3) float32 RGB in [0,255].

    Interleaved convenience form (tests / small arrays). Hot paths use
    :func:`yuv420_to_rgb_planes`.
    """
    return jnp.stack(yuv420_to_rgb_planes(y, u, v), axis=-1)


def yuv420_to_gray(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Planar YUV420 -> float32 gray in [0,255], matching the reference's
    decode-to-BGR-then-``cv2.COLOR_BGR2GRAY`` path to rounding tolerance.

    Composed affine form of (yuv->rgb ; luma weights), with the clip applied
    in RGB space first (the compositions differ only for out-of-gamut
    chroma). Pure elementwise chain over the channel PLANES — one fused XLA
    pass, no interleaved intermediate.
    """
    r, g, b = yuv420_to_rgb_planes(y, u, v)
    return r * GRAY_R + g * GRAY_G + b * GRAY_B


# --- NumPy mirrors (host-side test utilities / oracles) ---


def rgb_to_yuv420_np(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 full-range RGB -> planar BT.601 limited YUV420."""
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    u = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    v = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    # 2x2 average chroma subsampling.
    n, h, w = y.shape
    u2 = u.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    v2 = v.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    to_u8 = lambda x: np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return to_u8(y), to_u8(u2), to_u8(v2)


def yuv420_to_gray_np(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """NumPy oracle for :func:`yuv420_to_gray`."""
    yf = y.astype(np.float64) - 16.0
    uf = np.repeat(np.repeat(u.astype(np.float64), 2, -2), 2, -1) - 128.0
    vf = np.repeat(np.repeat(v.astype(np.float64), 2, -2), 2, -1) - 128.0
    uf = uf[..., : y.shape[-2], : y.shape[-1]]
    vf = vf[..., : y.shape[-2], : y.shape[-1]]
    r = np.clip(_Y_SCALE * yf + _V_R * vf, 0, 255)
    g = np.clip(_Y_SCALE * yf + _U_G * uf + _V_G * vf, 0, 255)
    b = np.clip(_Y_SCALE * yf + _U_B * uf, 0, 255)
    return GRAY_R * r + GRAY_G * g + GRAY_B * b
