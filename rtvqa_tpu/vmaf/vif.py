"""VIF (Visual Information Fidelity) feature — 4 scales, libvmaf semantics.

Replaces the VIF features the reference obtains via its libvmaf subprocess
(``video_processing.py:280-282``). Implements the float VIF algorithm used by
VMAF (per-scale Gaussian-window local statistics over the luma plane):

for scale k = 0..3, window N = 2^(4-k)+1 taps, sigma = N/5:
  * for k>0: blur ref/dis with this scale's window, decimate by 2;
  * local moments mu1, mu2, and central moments sigma1^2, sigma2^2, sigma12
    via the same window;
  * regression gain g = sigma12 / (sigma1^2 + eps), visual noise
    sv^2 = sigma2^2 - g*sigma12, with the standard VIF stability clamps;
  * vif_scale_k = sum(log2(1 + g^2 sigma1^2 / (sv^2 + sigma_nsq)))
                / sum(log2(1 + sigma1^2 / sigma_nsq)),  sigma_nsq = 2.

Border mode is mirrored reflection (libvmaf's vif_filter1d). All four scale
features (vmaf_vif_scale0..3) are returned per frame.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.vmaf.filters import decimate2, filter1d_sep, gaussian_kernel

_SIGMA_NSQ = 2.0
_EPS = 1e-10


def _vif_scale_stats(ref, dis, taps, enhn_gain_limit=None):
    mu1 = filter1d_sep(ref, taps)
    mu2 = filter1d_sep(dis, taps)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = filter1d_sep(ref * ref, taps) - mu1_sq
    sigma2_sq = filter1d_sep(dis * dis, taps) - mu2_sq
    sigma12 = filter1d_sep(ref * dis, taps) - mu1_mu2

    sigma1_sq = jnp.maximum(sigma1_sq, 0.0)
    sigma2_sq = jnp.maximum(sigma2_sq, 0.0)

    g = sigma12 / (sigma1_sq + _EPS)
    sv_sq = sigma2_sq - g * sigma12

    # Stability clamps (float_vif order).
    small1 = sigma1_sq < _EPS
    g = jnp.where(small1, 0.0, g)
    sv_sq = jnp.where(small1, sigma2_sq, sv_sq)
    sigma1_sq = jnp.where(small1, 0.0, sigma1_sq)

    small2 = sigma2_sq < _EPS
    g = jnp.where(small2, 0.0, g)
    sv_sq = jnp.where(small2, 0.0, sv_sq)

    neg_g = g < 0
    sv_sq = jnp.where(neg_g, sigma2_sq, sv_sq)
    g = jnp.where(neg_g, 0.0, g)
    sv_sq = jnp.maximum(sv_sq, _EPS)

    if enhn_gain_limit is not None:
        # NEG mode (e.g. vmaf_v0.6.1neg): cap the regression gain so contrast
        # enhancement cannot raise the score (libvmaf vif_enhn_gain_limit).
        g = jnp.minimum(g, enhn_gain_limit)

    num = jnp.log2(1.0 + g * g * sigma1_sq / (sv_sq + _SIGMA_NSQ))
    den = jnp.log2(1.0 + sigma1_sq / _SIGMA_NSQ)
    return jnp.sum(num, axis=(-2, -1)), jnp.sum(den, axis=(-2, -1))


def vif_features(
    ref_y: jnp.ndarray,
    dis_y: jnp.ndarray,
    enhn_gain_limit: float | None = None,
) -> dict[str, jnp.ndarray]:
    """Per-frame VIF at 4 scales over (..., H, W) float luma in [0, 255].

    ``enhn_gain_limit`` enables libvmaf's NEG mode (``vif_enhn_gain_limit``,
    carried by e.g. vmaf_v0.6.1neg.json): the per-window regression gain is
    capped so enhancement cannot inflate fidelity. None = classic VIF.

    Returns {'vif_scale0'..'vif_scale3'} arrays of shape (...,).
    """
    ref = ref_y.astype(jnp.float32)
    dis = dis_y.astype(jnp.float32)
    out = {}
    for scale in range(4):
        n = 2 ** (4 - scale) + 1
        taps = gaussian_kernel(n, n / 5.0)
        if scale > 0:
            ref = decimate2(filter1d_sep(ref, taps))
            dis = decimate2(filter1d_sep(dis, taps))
        num, den = _vif_scale_stats(ref, dis, taps, enhn_gain_limit)
        out[f"vif_scale{scale}"] = num / jnp.maximum(den, _EPS)
    return out


# --- NumPy oracle ----------------------------------------------------------


def vif_features_np(
    ref_y: np.ndarray, dis_y: np.ndarray, enhn_gain_limit: float | None = None
) -> dict[str, float]:
    """Loop-free but independent float64 implementation for golden tests
    (``enhn_gain_limit``: libvmaf's NEG-mode gain cap, as in vif_features)."""
    from rtvqa_tpu.vmaf.filters import filter1d_sep_np

    ref = ref_y.astype(np.float64)
    dis = dis_y.astype(np.float64)
    out = {}
    for scale in range(4):
        n = 2 ** (4 - scale) + 1
        taps = gaussian_kernel(n, n / 5.0)
        if scale > 0:
            ref = filter1d_sep_np(ref, taps)[::2, ::2]
            dis = filter1d_sep_np(dis, taps)[::2, ::2]
        mu1 = filter1d_sep_np(ref, taps)
        mu2 = filter1d_sep_np(dis, taps)
        s1 = np.maximum(filter1d_sep_np(ref * ref, taps) - mu1 * mu1, 0)
        s2 = np.maximum(filter1d_sep_np(dis * dis, taps) - mu2 * mu2, 0)
        s12 = filter1d_sep_np(ref * dis, taps) - mu1 * mu2
        g = s12 / (s1 + _EPS)
        sv = s2 - g * s12
        m1 = s1 < _EPS
        g[m1] = 0
        sv[m1] = s2[m1]
        s1 = s1.copy()
        s1[m1] = 0
        m2 = s2 < _EPS
        g[m2] = 0
        sv[m2] = 0
        mg = g < 0
        sv[mg] = s2[mg]
        g[mg] = 0
        sv = np.maximum(sv, _EPS)
        if enhn_gain_limit is not None:
            g = np.minimum(g, enhn_gain_limit)
        num = np.log2(1 + g * g * s1 / (sv + _SIGMA_NSQ)).sum()
        den = np.log2(1 + s1 / _SIGMA_NSQ).sum()
        out[f"vif_scale{scale}"] = float(num / max(den, _EPS))
    return out
