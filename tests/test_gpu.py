"""Card-only checks (marker ``gpu``): they skip without a GPU and run on the
card through ``chip_smoke.py`` (``pytest -m gpu tests/``).

Each compares what the card computes at small shapes with a float64 NumPy
reference, at the repository's own limits (docs/PARITY.md).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_backend_predicate_selects_gpu(gpu_device):
    from rtvqa_tpu.backend import on_gpu

    assert gpu_device.platform == "gpu"
    assert on_gpu()


def test_chunk_program_matches_float64_oracles(gpu_device, rng):
    from rtvqa_tpu.metrics.full_reference import CHUNK_KEYS, _program_chunk
    from rtvqa_tpu.vmaf.vif import vif_features_np
    from tests.oracles import adm as adm_oracle
    from tests.oracles import quality as q_oracle

    n, h, w = 3, 56, 70
    ry = rng.integers(0, 256, (n, h, w), np.uint8)
    ru = rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    dy = np.clip(ry.astype(np.int16) + rng.integers(-9, 10, ry.shape), 0, 255).astype(np.uint8)
    packed, _ = _program_chunk(ry, ru, ru, dy, ru, ru, np.zeros((h, w), np.float32), False)
    got = dict(zip(CHUNK_KEYS, np.asarray(packed)))
    for i in range(n):
        s = q_oracle.ssim_frame((ry[i], ru[i], ru[i]), (dy[i], ru[i], ru[i]))
        assert got["ssim_all"][i] == pytest.approx(s["ssim_all"], abs=1e-4)
        p = q_oracle.psnr_frame((ry[i], ru[i], ru[i]), (dy[i], ru[i], ru[i]))
        assert got["mse_avg"][i] == pytest.approx(p["mse_avg"], rel=1e-6)
        v = vif_features_np(ry[i], dy[i])
        for k in range(4):
            key = f"vif_scale{k}"
            assert got[key][i] == pytest.approx(v[key], rel=3e-4), key
        assert got["adm2"][i] == pytest.approx(adm_oracle.adm2(ry[i], dy[i]), rel=3e-4)


def test_f32_matmuls_are_not_tf32(gpu_device, rng):
    """Every f32 product on the path names HIGHEST precision; TF32 (about
    three decimal digits) would miss these limits by orders of magnitude."""
    from rtvqa_tpu.ops.dct import dct2, dct2_np
    from rtvqa_tpu.ops.resize import resize_bilinear, resize_bilinear_np
    from rtvqa_tpu.vmaf.model import builtin_model

    x = rng.uniform(0, 255, (2, 270, 480)).astype(np.float32)
    got = np.asarray(resize_bilinear(x, 64, 64))
    np.testing.assert_allclose(got, resize_bilinear_np(x, 64, 64), rtol=1e-6, atol=1e-4)
    g = rng.uniform(0, 255, (2, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(dct2(g)), dct2_np(g), rtol=1e-5, atol=2e-3)

    model = builtin_model()
    feats = {k: rng.uniform(0.2, 1.0, 16).astype(np.float32) for k in (
        "adm2", "motion2", "vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3")}
    w = np.asarray(model.weights, np.float64)
    slopes = np.asarray(model.slopes, np.float64)
    icpt = np.asarray(model.intercepts, np.float64)
    cols = np.stack([feats[k] for k in (
        "adm2", "motion2", "vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3")], -1)
    ref = ((cols * slopes[1:] + icpt[1:]) @ w + model.bias - icpt[0]) / slopes[0]
    if model.score_clip is not None:
        ref = np.clip(ref, *model.score_clip)
    np.testing.assert_allclose(np.asarray(model.predict(feats)), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,block,radius", [
    ((2, 540, 960), 8, 4), ((2, 1080, 1920), 16, 8), ((1, 1080, 1920), 8, 4),
    ((2, 68, 130), 8, 4), ((1, 32, 2176), 16, 4),
])
def test_motion_kernel_on_card_equals_scan(gpu_device, rng, shape, block, radius):
    """The compiled search kernel against the XLA scan at 1080p widths, on
    integer-valued frames: SAD sums are exact, so the fields are bitwise
    equal, ties included (a static block region)."""
    from rtvqa_tpu.kernels.motion_triton import block_match_field_triton
    from rtvqa_tpu.ops.motion import block_match_field

    prev = rng.integers(0, 256, shape).astype(np.float32)
    curr = np.roll(np.roll(prev, 3, -2), -2, -1)
    curr[..., :64, :64] = 17.0
    prev[..., :64, :64] = 17.0
    got = block_match_field_triton(prev, curr, block=block, radius=radius)
    want = block_match_field(prev, curr, block=block, radius=radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
