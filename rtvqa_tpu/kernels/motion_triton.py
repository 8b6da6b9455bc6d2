"""Exhaustive block-matching search as a GPU kernel (Pallas, Triton route).

The XLA form (``ops.motion.block_match_field``) is a ``lax.scan`` over the
(2r+1)^2 candidate displacements whose every step reads both frames from
device memory again. Here one program owns one (frame, block row, group of
block columns) tile: it loads the current frame's pixels once, then walks
every candidate in raster order, loading the displaced previous-frame tile
(the overlap between candidates is served by L1/L2) and keeping the best
SAD and its displacement in registers. Ties keep the first candidate (strict
``<`` in raster order), exactly as the scan does, so static scenes report 0.

Layout: a tile is (block, BC, block) — row within the block, block column,
column within the block — so the two minor dimensions are contiguous in
memory. BC, the block columns per program, is a power of two with masks on
the ragged last group. The previous frame is read with indices clamped to
the block-cropped frame, which is the scan's edge padding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Pixels per tile: keeps each per-thread share of the current tile, the
#: displaced tile and their difference in registers at 8 warps.
_TILE_PIXELS = 4096


def _search_kernel(prev_ref, curr_ref, dy_ref, dx_ref, *, block, radius, bc,
                   hb, wb, nbx):
    n = pl.program_id(0)
    by = pl.program_id(1)
    blk = pl.program_id(2) * bc + jnp.arange(bc)               # (BC,)
    shape = (block, bc, block)
    rows = jnp.broadcast_to(
        (by * block + jnp.arange(block))[:, None, None], shape)
    cols = jnp.broadcast_to(
        blk[None, :, None] * block + jnp.arange(block)[None, None, :], shape)
    valid = blk < nbx
    mask = jnp.broadcast_to(valid[None, :, None], shape)
    cur = plgpu.load(curr_ref.at[n, rows, jnp.minimum(cols, wb - 1)],
                     mask=mask, other=0.0)
    side = 2 * radius + 1

    # Candidates in raster order: dy outer, dx inner (no integer division,
    # which the Triton route does not lower for loop indices).
    def candidate_row(ddy, carry):
        dy = ddy - radius
        pr = jnp.clip(rows + dy, 0, hb - 1)

        def candidate(ddx, carry):
            best, best_dy, best_dx = carry
            dx = ddx - radius
            pc = jnp.clip(cols + dx, 0, wb - 1)
            prev = plgpu.load(prev_ref.at[n, pr, pc], mask=mask, other=0.0)
            sad = jnp.sum(jnp.abs(cur - prev), axis=(0, 2))      # (BC,)
            better = sad < best  # strict: the first (raster) minimum wins
            return (jnp.where(better, sad, best),
                    jnp.where(better, dy.astype(jnp.float32), best_dy),
                    jnp.where(better, dx.astype(jnp.float32), best_dx))

        return jax.lax.fori_loop(0, side, candidate, carry)

    init = (jnp.full((bc,), jnp.inf, jnp.float32),
            jnp.zeros((bc,), jnp.float32), jnp.zeros((bc,), jnp.float32))
    _, best_dy, best_dx = jax.lax.fori_loop(0, side, candidate_row, init)
    plgpu.store(dy_ref.at[n, by, blk], best_dy, mask=valid)
    plgpu.store(dx_ref.at[n, by, blk], best_dx, mask=valid)


@functools.partial(jax.jit, static_argnames=("block", "radius", "interpret"))
def block_match_field_triton(prev_gray, curr_gray, block: int = 16,
                             radius: int = 8, interpret: bool = False):
    """Same contract as ``ops.motion.block_match_field``: (..., H, W) pairs
    -> ((..., nby, nbx) dy, (..., nby, nbx) dx) float32. ``block`` must be a
    power of two."""
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    lead = curr_gray.shape[:-2]
    h, w = curr_gray.shape[-2:]
    nby, nbx = h // block, w // block
    hb, wb = nby * block, nbx * block
    curr = curr_gray.reshape(-1, h, w).astype(jnp.float32)
    prev = prev_gray.reshape(-1, h, w).astype(jnp.float32)
    frames = curr.shape[0]
    bc = max(1, min(pl.next_power_of_2(nbx), _TILE_PIXELS // (block * block)))
    kernel = functools.partial(_search_kernel, block=block, radius=radius,
                               bc=bc, hb=hb, wb=wb, nbx=nbx)
    field = jax.ShapeDtypeStruct((frames, nby, nbx), jnp.float32)
    dy, dx = pl.pallas_call(
        kernel,
        out_shape=(field, field),
        grid=(frames, nby, pl.cdiv(nbx, bc)),
        compiler_params=plgpu.CompilerParams(num_warps=8),
        interpret=interpret,
        name="block_match_search",
        backend="triton",
    )(prev, curr)
    return dy.reshape(*lead, nby, nbx), dx.reshape(*lead, nby, nbx)
