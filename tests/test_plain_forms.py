"""Plain forms of the quality bodies: strided decimation and integer 4x4
block sums must equal, bit for bit, the 0/1-matrix products they replaced;
and the one-program chunk must equal the split A/B programs through the
streaming chunk loop, blur carry and ragged-chunk padding included.
"""

import jax
import numpy as np
import pytest

from rtvqa_tpu.metrics import full_reference as fr
from rtvqa_tpu.metrics.quality import _block_sums_4x4, ssim_frames
from rtvqa_tpu.vmaf.filters import decimate2, even_lanes

SHAPES = [(53, 71), (56, 70), (40, 64), (67, 96), (130, 170), (135, 240), (108, 192)]
HIGHEST = jax.lax.Precision.HIGHEST


def _even_lanes_matmul(x):
    """The former selection-matmul form of ``even_lanes``."""
    n = x.shape[-1]
    sel = np.zeros((n, (n + 1) // 2), np.float32)
    sel[2 * np.arange(sel.shape[1]), np.arange(sel.shape[1])] = 1.0
    return jax.numpy.einsum("...hw,wc->...hc", x.astype(np.float32), sel,
                            preferred_element_type=np.float32, precision=HIGHEST)


def _block_sums_matmul(a):
    """The former pooling-matmul form of the SSIM 4x4 block sums."""
    def pool(n):
        m = np.zeros((n // 4, n), np.float32)
        for r in range(n // 4):
            m[r, 4 * r: 4 * r + 4] = 1.0
        return m

    x = a.astype(np.float32)
    y = jax.numpy.einsum("bh,...hw->...bw", pool(a.shape[-2]), x,
                         preferred_element_type=np.float32, precision=HIGHEST)
    return jax.numpy.einsum("cw,...bw->...bc", pool(a.shape[-1]), y,
                            preferred_element_type=np.float32, precision=HIGHEST)


@pytest.mark.parametrize("h,w", SHAPES)
def test_decimation_bitwise_equals_selection_matmul(rng, h, w):
    x = rng.normal(120.0, 40.0, (2, h, w)).astype(np.float32)
    got = np.asarray(jax.jit(even_lanes)(x))
    assert got.shape == (2, h, (w + 1) // 2)
    np.testing.assert_array_equal(got, np.asarray(_even_lanes_matmul(x)))
    got2 = np.asarray(jax.jit(decimate2)(x))
    assert got2.shape == (2, (h + 1) // 2, (w + 1) // 2)
    np.testing.assert_array_equal(got2, np.asarray(_even_lanes_matmul(x[..., ::2, :])))


@pytest.mark.parametrize("h,w", SHAPES)
def test_block_sums_bitwise_equal_pooling_matmul(rng, h, w):
    r = rng.integers(0, 256, (2, h, w)).astype(np.int32)
    d = rng.integers(0, 256, (2, h, w)).astype(np.int32)
    for a in (r, d, r * r + d * d, r * d):  # the four x264 sums
        got = np.asarray(jax.jit(_block_sums_4x4)(a))
        assert got.shape == (2, h // 4, w // 4) and got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(_block_sums_matmul(a)))
    # The SSIM built on them is finite and perfect on an identical pair.
    y = r.astype(np.uint8)
    c = y[:, : h // 2, : w // 2]
    s = ssim_frames(y, c, c, y, c, c)
    np.testing.assert_allclose(np.asarray(s["ssim_all"]), 1.0, atol=1e-6)


def _batches(planes, ts, chunk):
    from rtvqa_tpu.io.stream import FrameBatch

    y, u, v = planes
    for start in range(0, y.shape[0], chunk):
        sl = slice(start, start + chunk)
        yield FrameBatch(y[sl], u[sl], v[sl], ts[sl], start)


@pytest.mark.parametrize("h,w", SHAPES)
def test_program_chunk_matches_split_through_chunk_loop(rng, h, w, monkeypatch):
    """11 frames in chunks of 4: two full staged chunks and a ragged one
    padded by repeating its last frame; the blur carry crosses both chunk
    boundaries. The GPU dispatch (one program per chunk) must equal the CPU
    dispatch (programs A and B) row for row, and both must equal one
    unchunked call."""
    from rtvqa_tpu.io.stream import prefetch, stage_to_device

    n, chunk = 11, 4
    ry = rng.integers(0, 256, (n, h, w), np.uint8)
    ru = rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    rv = rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    dis = tuple(
        np.clip(p.astype(np.int16) + rng.integers(-9, 10, p.shape), 0, 255).astype(np.uint8)
        for p in (ry, ru, rv)
    )
    ts = np.arange(n) * 40.0

    def run(gpu_dispatch):
        monkeypatch.setattr(fr, "on_gpu", lambda: gpu_dispatch)
        return fr._quality_chunk_loop(
            prefetch(stage_to_device(_batches((ry, ru, rv), ts, chunk), chunk)),
            prefetch(stage_to_device(_batches(dis, ts, chunk), chunk)),
            chunk, None, None, None,
        )

    merged, n_m = run(True)
    split, n_s = run(False)
    assert n_m == n_s == n
    pa, _ = fr._program_a(ry, ru, rv, *dis, np.zeros((h, w), np.float32), False)
    pb = fr._program_b(ry, dis[0])
    whole = dict(zip(fr.CHUNK_KEYS, np.concatenate([np.asarray(pa), np.asarray(pb)])))
    for key in fr.CHUNK_KEYS:
        assert merged[key].shape == (n,)
        np.testing.assert_allclose(merged[key], split[key], rtol=1e-6, atol=1e-7,
                                   err_msg=key)
        # The deep VIF/ADM scales are tiny planes whose f32 sums XLA orders
        # by batch size (4-frame chunks vs 11 frames): the feature budget.
        rtol = 3e-4 if key in ("vif_scale2", "vif_scale3", "adm2") else 2e-6
        np.testing.assert_allclose(merged[key], whole[key], rtol=rtol, atol=1e-6,
                                   err_msg=key)
    assert merged["motion_sad"][0] == 0.0
