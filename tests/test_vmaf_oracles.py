"""The XLA VIF and ADM features (the bodies every platform runs) against
their float64 oracles, at awkward shapes: odd and ragged heights and widths,
and the 1080p deepest-scale geometries (135x240 is ADM's level 3 at 1080p).

Limits are docs/PARITY.md's: VIF scales and ADM2 within 3e-4 relative.
"""

import jax
import numpy as np
import pytest

from rtvqa_tpu.metrics.full_reference import B_KEYS, _program_b
from rtvqa_tpu.vmaf.adm import adm_features
from rtvqa_tpu.vmaf.vif import vif_features, vif_features_np
from tests.oracles import adm as adm_oracle

SHAPES = [(53, 71), (56, 70), (40, 64), (67, 96), (130, 170), (135, 240), (108, 192)]
REL = 3e-4

_vif = jax.jit(vif_features, static_argnames="enhn_gain_limit")
_adm = jax.jit(adm_features, static_argnames="enhn_gain_limit")


def make_pair(rng, h, w, b=2, noise=8):
    """Textured content (smooth pattern + noise) and a noisy copy."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (110 + 60 * np.sin(2 * np.pi * xx / 37.0)
            + 40 * np.cos(2 * np.pi * (xx + 2 * yy) / 53.0))
    ref = np.stack([np.clip(base + rng.normal(0, 10, (h, w)), 0, 255)
                    for _ in range(b)]).round().astype(np.float32)
    dis = np.clip(ref + rng.normal(0, noise, ref.shape), 0, 255).round()
    return ref, dis.astype(np.float32)


def enhanced_pair(rng, h, w, b=2):
    """Contrast enhancement: gains > 1 almost everywhere, so a NEG cap bites."""
    ref, _ = make_pair(rng, h, w, b)
    dis = np.clip((ref - 128.0) * 1.4 + 128.0 + rng.normal(0, 2, ref.shape), 0, 255)
    return ref, dis.round().astype(np.float32)


def _check_vif(ref, dis, egl=None):
    got = {k: np.asarray(v) for k, v in _vif(ref, dis, enhn_gain_limit=egl).items()}
    for i in range(ref.shape[0]):
        want = vif_features_np(ref[i], dis[i], enhn_gain_limit=egl)
        for k in range(4):
            key = f"vif_scale{k}"
            assert got[key][i] == pytest.approx(want[key], rel=REL), (i, key)
    return got


def _check_adm(ref, dis, egl=None):
    got = np.asarray(_adm(ref, dis, enhn_gain_limit=egl)["adm2"])
    for i in range(ref.shape[0]):
        want = adm_oracle.adm2(ref[i], dis[i], enhn_gain_limit=egl)
        assert got[i] == pytest.approx(want, rel=REL), i
    return got


@pytest.mark.parametrize("h,w", SHAPES)
def test_vif_matches_float64_oracle(rng, h, w):
    _check_vif(*make_pair(rng, h, w))


@pytest.mark.parametrize("h,w", SHAPES)
def test_adm_matches_float64_oracle(rng, h, w):
    _check_adm(*make_pair(rng, h, w))


@pytest.mark.parametrize("h,w", SHAPES)
def test_vif_neg_gain_limit_matches_oracle(rng, h, w):
    ref, dis = enhanced_pair(rng, h, w)
    capped = _check_vif(ref, dis, egl=1.0)
    uncapped = np.asarray(_vif(ref, dis)["vif_scale0"])
    assert capped["vif_scale0"].mean() < uncapped.mean() - 1e-3  # the cap bites


@pytest.mark.parametrize("h,w", SHAPES)
def test_adm_neg_gain_limit_matches_oracle(rng, h, w):
    ref, dis = enhanced_pair(rng, h, w)
    capped = _check_adm(ref, dis, egl=1.0)
    uncapped = np.asarray(_adm(ref, dis)["adm2"])
    assert np.all(capped <= uncapped + 1e-6)


@pytest.mark.parametrize("h,w", SHAPES)
def test_identity_inputs_score_one(rng, h, w):
    """An undistorted pair is perfect fidelity: every VIF scale and ADM2 is
    1 within the feature budget."""
    ref, _ = make_pair(rng, h, w, b=1)
    vif = _vif(ref, ref)
    for k in range(4):
        np.testing.assert_allclose(np.asarray(vif[f"vif_scale{k}"]), 1.0, rtol=REL)
    np.testing.assert_allclose(np.asarray(_adm(ref, ref)["adm2"]), 1.0, rtol=REL)


@pytest.mark.parametrize("h,w", SHAPES)
def test_program_b_uint8_equals_f32(rng, h, w):
    """Program B takes the decoded uint8 luma; converting it first to f32
    must change nothing (the conversion is exact), and its rows are the
    VIF/ADM features themselves."""
    ref, dis = make_pair(rng, h, w)
    got8 = np.asarray(_program_b(ref.astype(np.uint8), dis.astype(np.uint8)))
    got32 = np.asarray(_program_b(ref, dis))
    np.testing.assert_array_equal(got8, got32)
    feats = {**_vif(ref, dis), **_adm(ref, dis)}
    want = np.stack([np.asarray(feats[k]) for k in B_KEYS])
    np.testing.assert_allclose(got8, want, rtol=1e-6, atol=1e-7)
