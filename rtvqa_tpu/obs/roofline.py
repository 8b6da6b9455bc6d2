"""Analytic roofline accounting for the two device phases: the bytes and the
arithmetic one frame of each phase needs, set against the peak rates of the
device that ran it.

Counting rules
--------------
* **Bytes** are the device-memory traffic of a schedule that reads every
  input plane once and materializes each decimated scale once (written by
  one scale, read back by the next); the outputs are per-frame scalars. No
  cache is modelled, so this is a LOWER bound on real traffic and
  ``pct_bandwidth_roofline`` is a lower bound on how memory-bound a phase is.
* **FLOPs** count the filter arithmetic the algorithm needs: a K-tap
  separable pass is K multiply-adds per pixel per direction (VIF moments
  and decimation blurs, ADM's DWT, the motion blur, the resize contractions,
  the 64x64 DCT). It is f32 and, but for the small resize/DCT products,
  not a matrix product — so the compute bound is the f32 rate outside the
  tensor cores.
* **Elementwise ops** estimate the rest (block-match SAD candidates, VIF/
  SSIM/ADM per-pixel statistics) at one op per scalar operation, with ~2x
  slack: they say which bound a phase is near, not exactly where it sits.

Peaks come from one table keyed by ``jax.Device.device_kind``; a device that
is not in the table is an error, never a default.
"""

from __future__ import annotations

#: Published peaks per ``device_kind``: device-memory bytes/s, dense bf16
#: tensor-core FLOP/s, f32 FLOP/s outside the tensor cores. A card set below
#: its full power limit cannot hold these rates under load.
PEAKS = {
    # NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU datasheet; dense
    # rates without sparsity, at the part's 700 W power limit).
    "NVIDIA H100 80GB HBM3": {
        "bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,
        "f32_flops_per_s": 67e12,
    },
}

#: VIF Gaussian window taps per scale (vmaf/vif.py: N = 2^(4-k)+1).
VIF_TAPS = (17, 9, 5, 3)
#: ADM Daubechies-2 taps and DWT levels (vmaf/adm.py).
ADM_TAPS, ADM_LEVELS = 4, 4
#: VMAF motion blur taps (vmaf/motion.py FILTER_5).
MOTION_TAPS = 5


def peaks(device_kind: str) -> dict:
    """The published peak rates of ``device_kind`` (see ``PEAKS``)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add them to "
            "rtvqa_tpu.obs.roofline.PEAKS with their source"
        ) from None


def _sep_filter_flops(px: float, taps: int, n_arrays: int = 1) -> float:
    """FLOPs of ``n_arrays`` separable row+col K-tap filter passes: K
    multiply-adds per pixel per direction, 2 FLOPs per multiply-add."""
    return n_arrays * px * 2 * (2 * taps)


def quality_roofline(h: int, w: int) -> dict:
    """Per-frame bytes/FLOPs of the full-reference quality phase at (h, w):
    PSNR, SSIM, the VMAF motion blur, VIF scales 0-3 and ADM2.

    Bytes: the uint8 yuv420 pair is read once; the half-resolution f32
    ref/dis planes that feed VIF scale 1 and ADM level 1 are each written
    once and read back once; the luma pair is read a second time by ADM.
    """
    hw = float(h * w)
    yuv_pair = 3.0 * hw              # uint8 y + u + v, ref + dis (yuv420)
    half_pair = 2.0 * (hw / 4) * 4   # f32 half-res luma pair
    reads = yuv_pair + 2.0 * hw + 2.0 * half_pair
    writes = 2.0 * half_pair
    bytes_total = reads + writes

    # VIF stats need 5 filtered arrays (mu1, mu2, E[r^2], E[d^2], E[rd]) per
    # scale at hw/4^s px; +1 decimation blur per side for the next scale.
    flops = 0.0
    for s, taps in enumerate(VIF_TAPS):
        px = hw / (4.0 ** s)
        flops += _sep_filter_flops(px, taps, n_arrays=5)
        if s < 3:
            flops += _sep_filter_flops(px, taps, n_arrays=2)  # decimation
    # ADM: 4 DWT levels x (lo+hi rows, then lo+hi cols on each) x 2 images.
    px = hw
    for _ in range(ADM_LEVELS):
        flops += _sep_filter_flops(px, ADM_TAPS, n_arrays=2 * 3)
        px /= 4.0
    flops += _sep_filter_flops(hw, MOTION_TAPS, n_arrays=1)  # motion blur
    flops += hw / 16.0 * 2 * 16  # SSIM 4x4 block sums (luma)

    # Per-pixel statistics (VIF log terms, SSIM per-block formula, ADM
    # decouple/CSF/masking ~ tens of ops/px across 4 scales).
    elementwise = hw * (30 + 20) + (hw * 4 / 3) * 40
    return {
        "bytes_per_frame": bytes_total,
        "flops_per_frame": flops,
        "elementwise_ops_per_frame_est": elementwise,
    }


def complexity_roofline(h: int, w: int, radius: int = 8,
                        block: int = 16) -> dict:
    """Per-frame bytes/FLOPs of the complexity suite at (h, w), pyramid
    search: gray conversion reads y/u/v uint8 and writes f32 gray; the 2x2
    pooling reads it and writes the half-res plane; the search reads the
    pooled pair; resize-to-64, DCT, Sobel/Canny and entropies on 64x64 are
    byte-trivial; color entropy reads sampled rows (~1/8 of the planes).
    """
    hw = float(h * w)
    gray = hw * 4
    reads = 1.5 * hw + gray + 2 * (gray / 4) + 0.125 * 1.5 * hw
    writes = gray + gray / 4
    bytes_total = reads + writes

    side = 2 * (radius // 2) + 1  # half-res search: halved radius
    # SAD: |a-b| + accumulate = 2 ops per px per candidate, at hw/4 px.
    elementwise = (hw / 4.0) * side * side * 2 + hw * 10  # + gray/EWM/etc
    # Resize contractions + 64x64 DCT basis products (tiny).
    flops = _sep_filter_flops(hw, 2, n_arrays=1) + 2 * (64 * 64 * 64 * 2) * 2
    return {
        "bytes_per_frame": bytes_total,
        "flops_per_frame": flops,
        "elementwise_ops_per_frame_est": elementwise,
    }


def attach_measured(counts: dict, seconds_per_frame: float,
                    device_kind: str) -> dict:
    """Combine analytic counts with a per-frame time measured on
    ``device_kind`` into roofline shares (percent of each published peak)
    and the bound the counts put nearest."""
    p = peaks(device_kind)
    t = max(seconds_per_frame, 1e-12)
    t_bytes = counts["bytes_per_frame"] / p["bytes_per_s"]
    ops = counts["flops_per_frame"] + counts["elementwise_ops_per_frame_est"]
    t_ops = ops / p["f32_flops_per_s"]
    return {
        "device_kind": device_kind,
        "bytes_per_frame": round(counts["bytes_per_frame"]),
        "flops_per_frame": round(counts["flops_per_frame"]),
        "elementwise_ops_per_frame_est": round(
            counts["elementwise_ops_per_frame_est"]),
        "seconds_per_frame": seconds_per_frame,
        "pct_bandwidth_roofline": round(100 * t_bytes / t, 2),
        "pct_f32_roofline": round(100 * t_ops / t, 2),
        "bound": "memory" if t_bytes >= t_ops else "f32 compute",
    }
