"""Histogram + Shannon-entropy ops over frame batches.

Reference kernels (host, per frame, cv2.calcHist):

* gray entropy  — 256-bin hist of the gray frame, ``-sum_{p>0} p*log2(p)``
  (``complexity_metrics.py:392-416``; masking form);
* color entropy — per-channel B/G/R 256-bin hists, each normalized, entropy
  with a ``+1e-8`` epsilon *inside* the log, summed over channels
  (``complexity_metrics.py:418-475``; note the deliberate epsilon-vs-masking
  asymmetry between the two reference kernels — replicated here).

Device formulation: histograms over static 256 bins via a compare-and-reduce —
``hist[k] = sum(pix == k)`` evaluated as one fused broadcast-compare-reduction
(XLA keeps it streaming; no scatter needed, shapes stay static). Inputs are
float pixel values; binning uses round-to-nearest-even to mirror the uint8
quantization cv2 applies when converting color spaces on the host.
"""

from __future__ import annotations

import jax.numpy as jnp

_NBINS = 256


def histogram_256(x: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) float/int pixel values -> (..., 256) float32 counts.

    Float inputs are rounded to the nearest integer level and clipped to
    [0, 255] (uint8 quantization).
    """
    lead = x.shape[:-2]
    q = jnp.clip(jnp.round(x.astype(jnp.float32)), 0, 255).astype(jnp.int32)
    q = q.reshape(*lead, -1)
    bins = jnp.arange(_NBINS, dtype=jnp.int32)
    onehot = (q[..., None] == bins).astype(jnp.float32)
    return jnp.sum(onehot, axis=-2)


def entropy_masked(hist: jnp.ndarray) -> jnp.ndarray:
    """Shannon entropy ``-sum_{p>0} p log2 p`` over the trailing bin axis
    (gray-kernel form, ``complexity_metrics.py:413-414``)."""
    total = jnp.sum(hist, axis=-1, keepdims=True)
    p = hist / jnp.maximum(total, 1.0)
    logp = jnp.where(p > 0, jnp.log2(jnp.maximum(p, 1e-30)), 0.0)
    return -jnp.sum(p * logp, axis=-1)


def entropy_eps(hist: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Shannon entropy with epsilon inside the log (color-kernel form,
    ``complexity_metrics.py:471-473``)."""
    total = jnp.sum(hist, axis=-1, keepdims=True)
    p = hist / jnp.maximum(total, 1.0)
    return -jnp.sum(p * jnp.log2(p + eps), axis=-1)


def gray_entropy(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-frame gray histogram entropy over (..., H, W)."""
    return entropy_masked(histogram_256(gray))


def color_entropy(rgb: jnp.ndarray) -> jnp.ndarray:
    """Per-frame summed R/G/B histogram entropies over (..., H, W, 3).

    Channel order doesn't matter (the reference sums all three channel
    entropies, ``complexity_metrics.py:471-473``).
    """
    per_channel = jnp.moveaxis(rgb, -1, 0)  # (3, ..., H, W)
    ents = entropy_eps(histogram_256(per_channel))
    return jnp.sum(ents, axis=0)


def color_entropy_sampled(
    y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, out_h: int, out_w: int
) -> jnp.ndarray:
    """Color entropy of the bilinear-resized RGB frames, computed from the
    sampled rows only — bitwise-equal to ``color_entropy`` over
    full-res-convert + resize (reference path: decode to BGR, ``cv2.resize``,
    per-channel hists, ``complexity_metrics.py:418-475``).

    The 2-tap bilinear row pass reads <= 2*out_h of the H source rows, so
    this gathers those rows of the YUV planes, converts + clips ONLY them
    (chroma row replication becomes the index map r -> r//2), contracts
    with the compact row weights, then runs the dense column pass — the
    naive form materializes full-res clipped RGB planes only to read ~1/8
    of their rows. Stacking is channel-MAJOR, so every step stays
    elementwise over (..., H, W) planes.
    """
    import jax

    from rtvqa_tpu.ops.color import yuv_rows_to_rgb_planes
    from rtvqa_tpu.ops.resize import bilinear_sample_plan, resize_bilinear

    h = y.shape[-2]
    ridx, rmat = bilinear_sample_plan(out_h, h)
    y_rows = jnp.take(y, jnp.asarray(ridx), axis=-2)
    u_rows = jnp.take(u, jnp.asarray(ridx // 2), axis=-2)
    v_rows = jnp.take(v, jnp.asarray(ridx // 2), axis=-2)
    r_p, g_p, b_p = yuv_rows_to_rgb_planes(y_rows, u_rows, v_rows)
    rgb_rows = jnp.einsum(
        "oh,...chw->...cow", jnp.asarray(rmat, jnp.float32),
        jnp.stack([r_p, g_p, b_p], axis=-3),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                 # (..., 3, out_h, W)
    rgb_rs = resize_bilinear(rgb_rows, out_h, out_w)  # column pass only
    return color_entropy(jnp.moveaxis(rgb_rs, -3, -1))
