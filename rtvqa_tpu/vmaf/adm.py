"""ADM / DLM (Detail Loss Metric) feature — the ``adm2`` input to VMAF.

Implements the structure of libvmaf's float ADM (Li et al., "Image quality
assessment by separately evaluating detail losses and additive impairments",
IEEE TMM 2011), the second feature family the reference obtains via its
libvmaf subprocess (``video_processing.py:280-282``):

1. 4-level Daubechies-2 DWT of ref and dist luma (separable lo/hi filter
   pairs + decimation; mirrored borders). Each level yields (a, h, v, d);
   the approximation band ``a`` feeds the next level.
2. **Decoupling** per level: gain ``k = clip(t/o, 0, 1)`` per subband gives
   the restored (detail-loss) signal ``rst = k*o``; where the (h,v) angle
   between ref and dist coefficient vectors is within 1°, the distortion is
   deemed additive-free and ``rst = t`` (libvmaf's cos(1°) dot-product test).
3. **CSF weighting** with Watson's DWT noise-sensitivity model
   (a=0.495, k=0.466, f0=0.401, g=(1.501, 1, 0.534); viewing distance 3
   display heights of 1080 lines): ``rfactor = 1/Q(scale, orientation)``.
4. **Contrast masking**: the CSF-weighted additive residual ``a = t - rst``
   is spread over a 3x3 neighborhood (center weight 2, neighbors 1, /30) to
   form a masking threshold; the masked restored detail is
   ``max(|csf(rst)| - thr, 0)``.
5. **Pooling**: Minkowski L3 pooling of the masked detail (numerator) and of
   the CSF-weighted reference detail (denominator) over the center region
   (10% border crop per side), each with libvmaf's ``cbrt(area/32)`` offset;
   adm2 = sum(num over scales/bands) / sum(den).

Numerical parity with libvmaf cannot be measured in this environment (no
libvmaf binary/model on the machine — SURVEY.md §6); the implementation
follows the published algorithm and is validated by property tests
(identity → 1.0, detail-blur < 1, monotonicity) plus an independent NumPy
oracle with the same spec.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

# Daubechies-2 analysis filters (orthonormal).
DB2_LO = np.array(
    [0.482962913144690, 0.836516303737469, 0.224143868042013, -0.129409522550921]
)
DB2_HI = np.array(
    [-0.129409522550921, -0.224143868042013, 0.836516303737469, -0.482962913144690]
)

_COS_1DEG_SQ = math.cos(math.pi / 180.0) ** 2
_BORDER_FACTOR = 0.1
_WATSON = {"a": 0.495, "k": 0.466, "f0": 0.401, "g": (1.501, 1.0, 0.534)}
_NORM_VIEW_DIST = 3.0
_REF_DISPLAY_HEIGHT = 1080


@functools.lru_cache(maxsize=None)
def csf_rfactors(scale: int) -> tuple[float, float, float]:
    """(h, v, d) CSF weights 1/Q for a DWT level (0-based scale index)."""
    r = _NORM_VIEW_DIST * _REF_DISPLAY_HEIGHT * math.pi / 180.0

    def quant_step(theta: int) -> float:
        g = _WATSON["g"][theta]
        temp = math.log10((2.0 ** (scale + 1)) * _WATSON["f0"] * g / r)
        return 2.0 * _WATSON["a"] * (10.0 ** (_WATSON["k"] * temp * temp)) / g

    q_hv = quant_step(0)
    q_d = quant_step(1)
    return (1.0 / q_hv, 1.0 / q_hv, 1.0 / q_d)


def _dwt_1level(x: jnp.ndarray):
    """One db2 DWT level over trailing (H, W): returns (a, h, v, d), each
    (..., H/2, W/2). Mirrored borders; even-phase decimation."""
    from rtvqa_tpu.vmaf.filters import even_lanes, filter1d_sep_axis

    lo_rows = filter1d_sep_axis(x, DB2_LO, axis=-2)
    hi_rows = filter1d_sep_axis(x, DB2_HI, axis=-2)
    lo_rows = lo_rows[..., ::2, :]
    hi_rows = hi_rows[..., ::2, :]

    def cols(y, taps):
        return even_lanes(filter1d_sep_axis(y, taps, axis=-1))

    a = cols(lo_rows, DB2_LO)
    v = cols(hi_rows, DB2_LO)   # vertical detail: hi on rows, lo on cols
    h = cols(lo_rows, DB2_HI)   # horizontal detail: lo on rows, hi on cols
    d = cols(hi_rows, DB2_HI)
    return a, h, v, d


def _decouple(oh, ov, od, th, tv, td, enhn_gain_limit=None):
    eps = 1e-30
    ot_dp = oh * th + ov * tv
    o_mag_sq = oh * oh + ov * ov
    t_mag_sq = th * th + tv * tv
    angle_ok = (ot_dp >= 0.0) & (ot_dp * ot_dp >= _COS_1DEG_SQ * o_mag_sq * t_mag_sq)

    def restore(o, t):
        ratio = t / (o + jnp.where(o >= 0, eps, -eps))
        k = jnp.clip(ratio, 0.0, 1.0)
        rst = k * o
        if enhn_gain_limit is None:
            # Classic DLM: additive-free (within 1°) distortion restores fully.
            return jnp.where(angle_ok, t, rst)
        # NEG mode (libvmaf adm_enhn_gain_limit): even in the angle-ok branch
        # the restoration gain is capped, so enhancement (|t| > |o|) cannot
        # count as restored detail beyond the limit.
        k_neg = jnp.clip(ratio, 0.0, enhn_gain_limit)
        return jnp.where(angle_ok, k_neg * o, rst)

    rh, rv, rd = restore(oh, th), restore(ov, tv), restore(od, td)
    return (rh, rv, rd), (th - rh, tv - rv, td - rd)


def _mask_threshold(ah, av, ad):
    """3x3 spread of the summed |additive| across bands (center weight 2)."""
    x = jnp.abs(ah) + jnp.abs(av) + jnp.abs(ad)
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(x, pad, mode="edge")
    acc = 2.0 * x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            acc = acc + p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return acc / 30.0


def _center_crop_slices(h: int, w: int):
    top = max(int(h * _BORDER_FACTOR) - 1, 1)
    left = max(int(w * _BORDER_FACTOR) - 1, 1)
    bottom = h - top
    right = w - left
    return slice(top, bottom), slice(left, right)


def adm_features(
    ref_y: jnp.ndarray,
    dis_y: jnp.ndarray,
    enhn_gain_limit: float | None = None,
) -> dict[str, jnp.ndarray]:
    """Per-frame adm2 over (..., H, W) float luma. Returns {'adm2': (...)}.

    ``enhn_gain_limit`` enables libvmaf's NEG mode (``adm_enhn_gain_limit``):
    the decoupling gain is capped even where the 1° angle test passes, so
    enhancement cannot count as restored detail. None = classic DLM.
    """
    o = ref_y.astype(jnp.float32)
    t = dis_y.astype(jnp.float32)
    num_total = 0.0
    den_total = 0.0
    for scale in range(4):
        o, t, num, den = adm_one_scale(o, t, scale, enhn_gain_limit)
        num_total = num_total + num
        den_total = den_total + den
    return {"adm2": adm_finalize(num_total, den_total, ref_y.shape)}


def adm_one_scale(o, t, scale: int, enhn_gain_limit=None):
    """One DWT level + decoupling + CSF + masking + L3 pooling.

    Returns (a_ref, a_dis, num_contrib, den_contrib): the next level's inputs
    and this scale's contributions (already including the three per-band
    ``cbrt(area/32)`` offsets).
    """
    o, oh, ov, od = _dwt_1level(o)
    t, th, tv, td = _dwt_1level(t)
    (rh, rv, rd), (ah, av, ad) = _decouple(oh, ov, od, th, tv, td, enhn_gain_limit)
    fh, fv, fd = csf_rfactors(scale)
    thr = _mask_threshold(ah * fh, av * fv, ad * fd)
    hh, ww = oh.shape[-2], oh.shape[-1]
    ys, xs = _center_crop_slices(hh, ww)
    area = (ys.stop - ys.start) * (xs.stop - xs.start)
    offset = (area / 32.0) ** (1.0 / 3.0)
    num_total = 0.0
    den_total = 0.0
    for rst, orig, f in ((rh, oh, fh), (rv, ov, fv), (rd, od, fd)):
        masked = jnp.maximum(jnp.abs(rst * f) - thr, 0.0)
        num = jnp.sum(masked[..., ys, xs] ** 3.0, axis=(-2, -1)) ** (1.0 / 3.0)
        den = jnp.sum(
            jnp.abs(orig[..., ys, xs] * f) ** 3.0, axis=(-2, -1)
        ) ** (1.0 / 3.0)
        num_total = num_total + num + offset
        den_total = den_total + den + offset
    return o, t, num_total, den_total


def adm_finalize(num_total, den_total, luma_shape) -> jnp.ndarray:
    """adm2 from the summed per-scale contributions (degenerate-clip rule)."""
    h0, w0 = luma_shape[-2], luma_shape[-1]
    numden_limit = 1e-2 * (h0 * w0) / (1920.0 * 1080.0)
    return jnp.where(
        den_total < numden_limit, 1.0, num_total / jnp.maximum(den_total, 1e-30)
    )
