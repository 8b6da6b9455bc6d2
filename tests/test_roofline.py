"""Sanity checks for the analytic roofline accounting: byte counts must track
the closed-form input sizes, the measured-share helper must produce shares of
peak in (0, 100] for realistic timings, and the peak table must refuse a
device it does not know.
"""

import pytest

from rtvqa_tpu.obs.roofline import (
    PEAKS,
    attach_measured,
    complexity_roofline,
    peaks,
    quality_roofline,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_quality_bytes_scale_with_pixels():
    q1080 = quality_roofline(1080, 1920)
    q4k = quality_roofline(2160, 3840)
    for k in ("bytes_per_frame", "flops_per_frame"):
        assert q4k[k] == pytest.approx(4 * q1080[k], rel=1e-6)
    # Compulsory input floor: the raw yuv420 pair alone is 3*h*w bytes.
    assert q1080["bytes_per_frame"] >= 3 * 1080 * 1920


def test_complexity_counts_positive_and_sad_dominated():
    c = complexity_roofline(1080, 1920)
    assert c["bytes_per_frame"] > 1.5 * 1080 * 1920
    # The 81-candidate half-res SAD dominates the elementwise estimate.
    assert c["elementwise_ops_per_frame_est"] > (1080 * 1920 / 4) * 81


def test_attach_measured_percentages():
    q = attach_measured(quality_roofline(1080, 1920), 1e-3, H100)
    assert 0 < q["pct_bandwidth_roofline"] < 100
    assert 0 < q["pct_f32_roofline"] < 100
    assert q["seconds_per_frame"] == 1e-3
    assert q["device_kind"] == H100
    # At 1 ms/frame the quality phase's arithmetic, not its bytes, is the
    # nearer bound: ~1.7 G f32 ops vs ~27 MB per 1080p frame.
    assert q["bound"] == "f32 compute"
    assert q["pct_f32_roofline"] > q["pct_bandwidth_roofline"]


def test_peaks_known_device():
    p = peaks(H100)
    assert p is PEAKS[H100]
    assert p["bytes_per_s"] == 3.35e12
    assert p["bf16_flops_per_s"] == 989e12
    assert p["f32_flops_per_s"] == 67e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_peaks_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        peaks(kind)
    with pytest.raises(ValueError):
        attach_measured(complexity_roofline(1080, 1920), 1e-3, kind)
