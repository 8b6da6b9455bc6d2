"""The Triton-route block-match search kernel in interpret mode against the
XLA scan, and the one predicate that chooses between them.

Frames are integer-valued, so every SAD is an exact f32 sum and the kernel's
fields must equal the scan's bit for bit — ties included.
"""

import numpy as np
import pytest

from rtvqa_tpu.kernels.motion_triton import block_match_field_triton
from rtvqa_tpu.ops import motion
from rtvqa_tpu.ops.motion import block_match_field


def _shifted_pair(rng, n, h, w, dy, dx):
    prev = rng.integers(0, 256, (n, h, w)).astype(np.float32)
    curr = np.roll(np.roll(prev, dy, -2), dx, -1)
    return prev, curr


@pytest.mark.parametrize("n,h,w,block,radius", [
    (2, 48, 64, 16, 8),     # full-resolution defaults
    (2, 64, 128, 16, 4),
    (2, 34, 65, 8, 4),      # the pyramid's half-res search, odd dims
    (2, 150, 128, 8, 4),    # ragged block rows
    (1, 64, 1408, 8, 8),    # wide frame, full radius
    (1, 32, 2176, 16, 4),   # > 128 block columns: several column groups
    (2, 270, 256, 8, 4),
])
def test_kernel_interpret_equals_scan(rng, n, h, w, block, radius):
    prev, curr = _shifted_pair(rng, n, h, w, 2, -3)
    curr[:, :16, :24] = 7.0  # a flat patch: many exactly tied candidates
    prev[:, :16, :24] = 7.0
    got = block_match_field_triton(prev, curr, block=block, radius=radius,
                                   interpret=True)
    want = block_match_field(prev, curr, block=block, radius=radius)
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape == (n, h // block, w // block)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(wnt))


def test_kernel_static_scene_is_zero(rng):
    f = rng.integers(0, 256, (2, 40, 72)).astype(np.float32)
    dy, dx = block_match_field_triton(f, f, block=8, radius=4, interpret=True)
    assert not np.asarray(dy).any() and not np.asarray(dx).any()


def test_kernel_rejects_non_power_of_two_block(rng):
    f = rng.integers(0, 256, (1, 48, 48)).astype(np.float32)
    with pytest.raises(ValueError, match="power of two"):
        block_match_field_triton(f, f, block=12, radius=2, interpret=True)


@pytest.mark.parametrize("gpu", [True, False])
def test_one_predicate_chooses_kernel_or_scan(rng, monkeypatch, gpu):
    """``backend.on_gpu`` alone picks the kernel (GPU) or the scan."""
    calls = []

    def kernel(prev, curr, block, radius):
        calls.append("kernel")
        return block_match_field_triton(prev, curr, block=block, radius=radius,
                                        interpret=True)

    import rtvqa_tpu.kernels.motion_triton as mt

    monkeypatch.setattr(motion, "on_gpu", lambda: gpu)
    monkeypatch.setattr(mt, "block_match_field_triton", kernel)
    prev, curr = _shifted_pair(rng, 2, 48, 64, 2, 2)
    got = float(np.asarray(motion.block_match_motion(prev, curr, 16, 8))[0])
    assert calls == (["kernel"] if gpu else [])
    assert got == pytest.approx(np.hypot(2, 2), rel=0.35)
