"""Golden-value tests: JAX complexity ops vs independent NumPy/SciPy oracles
on synthetic frames (constant, gradient, noise, checkerboard) — SURVEY.md §4."""

import numpy as np
import pytest

from rtvqa_tpu.ops import dct as jdct
from rtvqa_tpu.ops import edges as jedges
from rtvqa_tpu.ops import histogram as jhist
from rtvqa_tpu.ops import motion as jmotion
from tests.oracles import complexity as oracle


def synthetic_frames(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return {
        "constant": np.full((h, w), 128.0, np.float32),
        "gradient": (xx * 255.0 / (w - 1)).astype(np.float32),
        "noise": rng.integers(0, 256, (h, w)).astype(np.float32),
        "checkerboard": (((yy // 4 + xx // 4) % 2) * 255).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["constant", "gradient", "noise", "checkerboard"])
def test_dct2_matches_scipy(name):
    f = synthetic_frames()[name]
    got = np.asarray(jdct.dct2(f[None]))[0]
    expected = oracle.dct2(f)
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-2)


def test_dct_energy_parseval(rng):
    f = rng.integers(0, 256, (2, 32, 32)).astype(np.float32)
    got = np.asarray(jdct.dct_energy(f))
    explicit = np.sum(np.asarray(jdct.dct2(f)) ** 2, axis=(-2, -1))
    for i in range(2):
        assert got[i] == pytest.approx(oracle.dct_energy(f[i]), rel=1e-5)
    np.testing.assert_allclose(got, explicit, rtol=1e-4)


def test_temporal_dct_linearity(rng):
    a = rng.integers(0, 256, (24, 24)).astype(np.float32)
    b = rng.integers(0, 256, (24, 24)).astype(np.float32)
    got = float(np.asarray(jdct.temporal_dct_abs_diff(a[None], b[None]))[0])
    assert got == pytest.approx(oracle.temporal_dct(a, b), rel=1e-4)


def test_blockwise_dct8x8(rng):
    f = rng.normal(size=(16, 24)).astype(np.float32)
    got = np.asarray(jdct.blockwise_dct8x8(f))
    for by in range(2):
        for bx in range(3):
            blk = f[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8]
            np.testing.assert_allclose(got[by, bx], oracle.dct2(blk), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["constant", "gradient", "noise", "checkerboard"])
def test_gray_entropy(name):
    f = synthetic_frames()[name]
    got = float(np.asarray(jhist.gray_entropy(f[None]))[0])
    expected = oracle.gray_entropy(np.clip(np.round(f), 0, 255).astype(np.uint8))
    assert got == pytest.approx(expected, abs=1e-4)


def test_color_entropy(rng):
    rgb = rng.integers(0, 256, (20, 28, 3)).astype(np.float32)
    got = float(np.asarray(jhist.color_entropy(rgb[None]))[0])
    expected = oracle.color_entropy(rgb.astype(np.uint8))
    assert got == pytest.approx(expected, abs=1e-3)


def test_entropy_extremes():
    const = np.full((1, 16, 16), 42.0, np.float32)
    assert float(np.asarray(jhist.gray_entropy(const))[0]) == pytest.approx(0.0, abs=1e-6)
    # Uniform over all 256 levels -> entropy 8 bits.
    uniform = np.arange(256, dtype=np.float32).reshape(1, 16, 16)
    assert float(np.asarray(jhist.gray_entropy(uniform))[0]) == pytest.approx(8.0, abs=1e-5)


@pytest.mark.parametrize("name", ["gradient", "noise", "checkerboard"])
def test_sobel_matches_oracle(name):
    f = synthetic_frames(h=24, w=32)[name]
    gx, gy = jedges.sobel_gradients(f[None])
    ogx, ogy = oracle.sobel(f)
    np.testing.assert_allclose(np.asarray(gx)[0], ogx, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gy)[0], ogy, atol=1e-3)


@pytest.mark.parametrize("name", ["constant", "gradient", "noise", "checkerboard"])
def test_canny_matches_oracle(name):
    f = synthetic_frames(h=24, w=32, seed=3)[name]
    got = np.asarray(jedges.canny_edges(f[None]))[0]
    expected = oracle.canny(f)
    np.testing.assert_array_equal(got, expected)


def test_canny_count_zero_on_constant():
    f = np.full((1, 32, 32), 99.0, np.float32)
    assert float(np.asarray(jedges.canny_edge_count(f))[0]) == 0.0


def test_canny_hysteresis_long_serpentine_chain():
    """Hysteresis must propagate along a weak chain far longer than the old
    64-round cap (VERDICT r1 weak #6): a serpentine ridge of ~H*W/4 pixels is
    seeded strong at one end and must be fully recovered, matching the
    (unbounded BFS) oracle exactly."""
    h, w = 40, 40
    f = np.zeros((h, w), np.float32)
    # Serpentine ridge: rows 1, 5, 9, ... carry a full-width line; vertical
    # connectors alternate sides. Ridge amplitude -> weak edges everywhere
    # (Sobel L1 magnitude between low=100 and high=200), except one hot
    # terminal pixel that seeds strong.
    amp = 40.0
    for r in range(1, h - 1, 4):
        f[r, 1:-1] = amp
        side = -2 if (r // 4) % 2 else 1
        if r + 4 < h - 1:
            f[r : r + 5, side] = amp
    f[1, 1] = 255.0  # strong seed at the chain's start
    got = np.asarray(jedges.canny_edges(f[None]))[0]
    expected = oracle.canny(f)
    np.testing.assert_array_equal(got, expected)
    # The chain really is longer than the old cap and really got picked up.
    assert got.sum() > 64


def test_block_match_static_scene(rng):
    f = rng.integers(0, 256, (48, 64)).astype(np.float32)
    got = float(np.asarray(jmotion.block_match_motion(f[None], f[None]))[0])
    assert got == 0.0


def test_block_match_known_shift(rng):
    # Shift a textured frame 3px right / 2px down: every block should find it.
    base = rng.integers(0, 256, (80, 96)).astype(np.float32)
    prev = base
    curr = np.roll(np.roll(base, 2, axis=0), 3, axis=1)
    # Interior blocks see a clean (2,3) displacement = magnitude sqrt(13).
    got = float(np.asarray(jmotion.block_match_motion(prev[None], curr[None], block=16, radius=8))[0])
    expected = oracle.block_match_motion(prev, curr, block=16, radius=8)
    assert got == pytest.approx(expected, rel=1e-6)
    assert got == pytest.approx(np.hypot(2, 3), rel=0.35)  # borders dilute slightly


def test_block_match_matches_oracle_random(rng):
    prev = rng.integers(0, 256, (32, 48)).astype(np.float32)
    curr = rng.integers(0, 256, (32, 48)).astype(np.float32)
    got = float(np.asarray(jmotion.block_match_motion(prev[None], curr[None], block=8, radius=4))[0])
    expected = oracle.block_match_motion(prev, curr, block=8, radius=4)
    assert got == pytest.approx(expected, rel=1e-6)


def test_pyramid_matches_oracle_random(rng):
    prev = rng.integers(0, 256, (64, 96)).astype(np.float32)
    curr = rng.integers(0, 256, (64, 96)).astype(np.float32)
    got = float(np.asarray(
        jmotion.block_match_motion_pyramid(prev[None], curr[None], block=16, radius=8)
    )[0])
    expected = oracle.block_match_motion_pyramid(prev, curr, block=16, radius=8)
    assert got == pytest.approx(expected, rel=1e-6)


def test_pyramid_static_scene_odd_dims(rng):
    # Odd H/W exercise the 2x2-pool crop; static scenes stay exactly 0.
    f = rng.integers(0, 256, (54, 62)).astype(np.float32)
    got = float(np.asarray(jmotion.block_match_motion_pyramid(f[None], f[None]))[0])
    assert got == 0.0


def test_pyramid_recovers_even_shift(rng):
    # An even full-resolution shift lands exactly on the half-res search
    # grid, so the scaled-back magnitude matches the true displacement.
    base = rng.integers(0, 256, (96, 128)).astype(np.float32)
    curr = np.roll(np.roll(base, 4, axis=0), 6, axis=1)
    got = float(np.asarray(
        jmotion.block_match_motion_pyramid(base[None], curr[None], block=16, radius=8)
    )[0])
    expected = oracle.block_match_motion_pyramid(base, curr, block=16, radius=8)
    assert got == pytest.approx(expected, rel=1e-6)
    assert got == pytest.approx(np.hypot(4, 6), rel=0.35)  # borders dilute


def test_pyramid2_static_scene(rng):
    f = rng.integers(0, 256, (3, 96, 128)).astype(np.float32)
    series = np.repeat(f[:1], 3, axis=0)
    got = np.asarray(jmotion.block_match_motion_pyramid2_series(series))
    np.testing.assert_array_equal(got, 0.0)


def test_pyramid2_recovers_multiple_of_4_shift(rng):
    """A multiple-of-4 shift lands exactly on the quarter-res grid; the
    half-res refinement contributes 0 — the two-level pyramid recovers it."""
    base = rng.integers(0, 256, (96, 128)).astype(np.float32)
    curr = np.roll(np.roll(base, 4, axis=0), 8, axis=1)
    series = np.stack([base, curr])
    got = float(np.asarray(
        jmotion.block_match_motion_pyramid2_series(series, block=16, radius=8)
    )[0])
    assert got == pytest.approx(np.hypot(4, 8), rel=0.35)  # borders dilute


def test_pyramid2_documented_failure_mode(rng):
    """WHY pyramid2 is NOT the production default (VERDICT r3 next #3
    experiment, documented dead end): a 2-px full-res shift is exactly 1
    half-res px — the single-level pyramid finds the zero-SAD displacement
    and reports exactly 2.0. At QUARTER res the same shift is half a pixel:
    the pooled SAD landscape is ambiguous on both textured AND smooth
    periodic content, the 4x4-quarter-px coarse blocks argmin essentially at
    random within ±rq, and the ±1 half-res refinement cannot recover from a
    wrong coarse vector — the metric drifts far from truth. Perf was never
    measured: the value drift disqualifies the scheme first
    (docs/PARITY.md §motion)."""
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    smooth = (
        120 + 60 * np.sin(2 * np.pi * xx / 40.0)
        + 40 * np.cos(2 * np.pi * (xx + yy) / 56.0)
    ).astype(np.float32)
    texture = rng.integers(0, 256, (96, 128)).astype(np.float32)
    for base in (smooth, texture):
        curr = np.roll(base, 2, axis=1)  # = exactly 1 half-res px
        one_level = float(np.asarray(
            jmotion.block_match_motion_pyramid(base[None], curr[None])
        )[0])
        assert one_level == pytest.approx(2.0, rel=1e-6)  # exact at half res
        two_level = float(np.asarray(
            jmotion.block_match_motion_pyramid2_series(np.stack([base, curr]))
        )[0])
        assert abs(two_level - 2.0) > 0.5, (
            "pyramid2 unexpectedly accurate — re-evaluate the dead-end "
            "verdict"
        )


def test_down2_mean_bitwise_forms(rng):
    # The pyramid argmin breaks ties by value, so the production
    # reduce_window form must stay BITWISE equal to the reshape-reduce form
    # and the NumPy oracle (sums of four u8-derived f32 values are exact and
    # 0.25* is a power-of-two scale). Odd dims exercise the crop.
    x = rng.integers(0, 256, (3, 53, 67)).astype(np.float32)
    a = np.asarray(jmotion.down2_mean(x))
    reshaped = 0.25 * x[:, :52, :66].reshape(3, 26, 2, 33, 2).sum(axis=(-3, -1))
    np.testing.assert_array_equal(a, reshaped)
    for i in range(x.shape[0]):  # the NumPy oracle is per-frame 2D
        np.testing.assert_array_equal(a[i], oracle.down2_mean(x[i]))


def test_fps_variation():
    ts = np.array([0.0, 100.0, 200.0, 200.0, 300.0], np.float64)
    valid = np.ones(5, bool)
    fps, pv = jmotion.fps_variation(ts, valid)
    np.testing.assert_allclose(np.asarray(fps), [10.0, 10.0, 0.0, 10.0], atol=1e-5)
    assert np.all(np.asarray(pv))
