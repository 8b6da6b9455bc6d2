import numpy as np

from rtvqa_tpu.ops.color import (
    rgb_to_yuv420_np,
    yuv420_to_gray,
    yuv420_to_gray_np,
    yuv420_to_rgb,
    yuv420_to_rgb_planes,
)
from rtvqa_tpu.ops.resize import resize_bilinear, resize_bilinear_np


def test_yuv_rgb_roundtrip_smooth():
    # Smooth content survives 4:2:0 chroma subsampling nearly losslessly.
    yy, xx = np.mgrid[0:32, 0:48]
    r = (xx * 5 % 256).astype(np.uint8)
    g = (yy * 5 % 256).astype(np.uint8)
    b = ((xx + yy) * 2 % 256).astype(np.uint8)
    rgb = np.stack([r, g, b], -1)[None]
    y, u, v = rgb_to_yuv420_np(rgb)
    back = np.asarray(yuv420_to_rgb(y, u, v))
    assert float(np.mean(np.abs(back - rgb.astype(np.float32)))) < 4.0


def test_yuv_rgb_roundtrip_noise(rng):
    # Pure noise is the chroma-subsampling worst case (2x2-averaged chroma,
    # amplified by the conversion gains): only a loose RGB bound holds, but
    # the luma must survive the roundtrip tightly.
    rgb = rng.integers(0, 256, size=(3, 32, 48, 3), dtype=np.uint8)
    y, u, v = rgb_to_yuv420_np(rgb)
    back = np.asarray(yuv420_to_rgb(y, u, v))
    assert float(np.mean(np.abs(back - rgb.astype(np.float32)))) < 60.0
    y2, _, _ = rgb_to_yuv420_np(np.clip(np.rint(back), 0, 255).astype(np.uint8))
    assert float(np.mean(np.abs(y2.astype(np.float32) - y.astype(np.float32)))) < 2.5


def test_rgb_planes_match_interleaved(rng):
    # The hot-path planar form (channel-MAJOR layout) must be
    # bitwise-identical per channel to the interleaved convenience form.
    rgb = rng.integers(0, 256, (2, 24, 32, 3), np.uint8)
    y, u, v = rgb_to_yuv420_np(rgb)
    r, g, b = (np.asarray(p) for p in yuv420_to_rgb_planes(y, u, v))
    inter = np.asarray(yuv420_to_rgb(y, u, v))
    np.testing.assert_array_equal(r, inter[..., 0])
    np.testing.assert_array_equal(g, inter[..., 1])
    np.testing.assert_array_equal(b, inter[..., 2])


def test_gray_matches_oracle(rng):
    rgb = rng.integers(0, 256, size=(2, 16, 24, 3), dtype=np.uint8)
    y, u, v = rgb_to_yuv420_np(rgb)
    got = np.asarray(yuv420_to_gray(y, u, v))
    expected = yuv420_to_gray_np(y, u, v)
    np.testing.assert_allclose(got, expected, atol=1e-2)


def test_gray_of_neutral_is_scaled_luma():
    # With neutral chroma (128), gray == (Y-16)*255/219 exactly.
    y = np.linspace(16, 235, 64, dtype=np.uint8).reshape(1, 8, 8)
    u = np.full((1, 4, 4), 128, np.uint8)
    v = np.full((1, 4, 4), 128, np.uint8)
    got = np.asarray(yuv420_to_gray(y, u, v))
    expected = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    np.testing.assert_allclose(got, expected, atol=1e-2)


def test_resize_identity(rng):
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(resize_bilinear(x, 16, 16)), x, atol=1e-6)


def test_resize_matches_oracle(rng):
    x = rng.integers(0, 256, size=(2, 96, 128)).astype(np.float32)
    got = np.asarray(resize_bilinear(x, 64, 64))
    expected = resize_bilinear_np(x, 64, 64)
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-3)


def test_resize_upscale_constant():
    x = np.full((1, 4, 4), 7.0, np.float32)
    got = np.asarray(resize_bilinear(x, 9, 13))
    np.testing.assert_allclose(got, 7.0, atol=1e-5)


def test_resize_matches_cv2_semantics():
    # Hand-checked cv2.resize INTER_LINEAR example: 1D ramp downscale 2x.
    x = np.arange(8, dtype=np.float32).reshape(1, 1, 8)
    got = np.asarray(resize_bilinear(x, 1, 4))
    # src positions: (i+0.5)*2-0.5 = 0.5, 2.5, 4.5, 6.5
    np.testing.assert_allclose(got[0, 0], [0.5, 2.5, 4.5, 6.5], atol=1e-5)


def test_resize_bilinear_sampled_bitwise_equal(rng):
    # The gathered row pass must be BITWISE equal to the dense contraction:
    # it sums the same <=2 nonzero taps (dropping exact zero terms is exact
    # in f32).
    from rtvqa_tpu.ops.resize import resize_bilinear_sampled

    for h, w, oh, ow in ((270, 480, 64, 64), (64, 64, 64, 64), (67, 93, 9, 13)):
        x = rng.random((3, h, w)).astype(np.float32) * 255.0
        dense = np.asarray(resize_bilinear(x, oh, ow))
        sampled = np.asarray(resize_bilinear_sampled(x, oh, ow))
        np.testing.assert_array_equal(sampled, dense)


def test_color_entropy_sampled_bitwise_equal(rng):
    # Sampled-rows color path == full-res convert + channel-major resize +
    # entropy (the round-3c/3g production forms), bitwise.
    import jax.numpy as jnp

    from rtvqa_tpu.ops.histogram import color_entropy, color_entropy_sampled

    y = rng.integers(0, 256, (3, 54, 96), dtype=np.uint8)
    u = rng.integers(0, 256, (3, 27, 48), dtype=np.uint8)
    v = rng.integers(0, 256, (3, 27, 48), dtype=np.uint8)
    r_p, g_p, b_p = yuv420_to_rgb_planes(y, u, v)
    dense = np.asarray(
        color_entropy(
            jnp.moveaxis(
                resize_bilinear(jnp.stack([r_p, g_p, b_p], axis=1), 16, 16),
                1, -1,
            )
        )
    )
    sampled = np.asarray(color_entropy_sampled(y, u, v, 16, 16))
    np.testing.assert_array_equal(sampled, dense)
