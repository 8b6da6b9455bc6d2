"""Independent NumPy oracle for the ADM/DLM feature (same published spec as
rtvqa_tpu.vmaf.adm, implemented with plain loops/scipy-free numpy)."""

from __future__ import annotations

import math

import numpy as np

DB2_LO = np.array(
    [0.482962913144690, 0.836516303737469, 0.224143868042013, -0.129409522550921]
)
DB2_HI = np.array(
    [-0.129409522550921, -0.224143868042013, 0.836516303737469, -0.482962913144690]
)
COS_1DEG_SQ = math.cos(math.pi / 180.0) ** 2


def conv1d_reflect(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    n = len(taps)
    half = n // 2
    length = x.shape[axis]
    out = np.zeros_like(x, dtype=np.float64)
    for t in range(n):
        idx = np.arange(length) + t - half
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= length, 2 * length - 2 - idx, idx)
        idx = np.clip(idx, 0, length - 1)
        out += taps[t] * np.take(x, idx, axis=axis)
    return out


def dwt_level(x: np.ndarray):
    lo_r = conv1d_reflect(x, DB2_LO, -2)[..., ::2, :]
    hi_r = conv1d_reflect(x, DB2_HI, -2)[..., ::2, :]
    a = conv1d_reflect(lo_r, DB2_LO, -1)[..., :, ::2]
    h = conv1d_reflect(lo_r, DB2_HI, -1)[..., :, ::2]
    v = conv1d_reflect(hi_r, DB2_LO, -1)[..., :, ::2]
    d = conv1d_reflect(hi_r, DB2_HI, -1)[..., :, ::2]
    return a, h, v, d


def csf_rfactors(scale: int):
    a, k, f0 = 0.495, 0.466, 0.401
    g = (1.501, 1.0, 0.534)
    r = 3.0 * 1080 * math.pi / 180.0

    def q(theta):
        temp = math.log10((2.0 ** (scale + 1)) * f0 * g[theta] / r)
        return 2.0 * a * (10.0 ** (k * temp * temp)) / g[theta]

    return 1.0 / q(0), 1.0 / q(0), 1.0 / q(1)


def adm2(ref: np.ndarray, dis: np.ndarray, enhn_gain_limit=None) -> float:
    """adm2 of one frame pair; ``enhn_gain_limit`` caps the restoration gain
    even where the 1-degree angle test passes (libvmaf NEG mode)."""
    o = ref.astype(np.float64)
    t = dis.astype(np.float64)
    num_total = den_total = 0.0
    for scale in range(4):
        o, oh, ov, od = dwt_level(o)
        t, th, tv, td = dwt_level(t)
        ot = oh * th + ov * tv
        angle = (ot >= 0) & (ot * ot >= COS_1DEG_SQ * (oh**2 + ov**2) * (th**2 + tv**2))

        def restore(oo, tt):
            eps = np.where(oo >= 0, 1e-30, -1e-30)
            kk = np.clip(tt / (oo + eps), 0.0, 1.0)
            if enhn_gain_limit is None:
                return np.where(angle, tt, kk * oo)
            k_neg = np.clip(tt / (oo + eps), 0.0, enhn_gain_limit)
            return np.where(angle, k_neg * oo, kk * oo)

        rh, rv_, rd = restore(oh, th), restore(ov, tv), restore(od, td)
        ah, av, ad = th - rh, tv - rv_, td - rd
        fh, fv, fd = csf_rfactors(scale)

        spread = np.abs(ah * fh) + np.abs(av * fv) + np.abs(ad * fd)
        hh, ww = spread.shape[-2:]
        p = np.pad(spread, 1, mode="edge")
        thr = 2.0 * spread
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    thr = thr + p[1 + dy : 1 + dy + hh, 1 + dx : 1 + dx + ww]
        thr = thr / 30.0

        top = max(int(hh * 0.1) - 1, 1)
        left = max(int(ww * 0.1) - 1, 1)
        ys, xs = slice(top, hh - top), slice(left, ww - left)
        area = (hh - 2 * top) * (ww - 2 * left)
        offset = (area / 32.0) ** (1.0 / 3.0)
        for rst, orig, f in ((rh, oh, fh), (rv_, ov, fv), (rd, od, fd)):
            masked = np.maximum(np.abs(rst * f) - thr, 0.0)
            num = (masked[ys, xs] ** 3).sum() ** (1.0 / 3.0)
            den = (np.abs(orig[ys, xs] * f) ** 3).sum() ** (1.0 / 3.0)
            num_total += num + offset
            den_total += den + offset
    h0, w0 = ref.shape[-2:]
    limit = 1e-2 * (h0 * w0) / (1920.0 * 1080.0)
    if den_total < limit:
        return 1.0
    return float(num_total / den_total)
