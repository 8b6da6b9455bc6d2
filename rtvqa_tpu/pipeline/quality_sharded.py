"""Multi-chip full-reference quality analysis (PSNR/SSIM/VMAF) for one clip
pair, frames sharded over the mesh's "frame" axis — STREAMING.

The reference buys these metrics from one single-process ffmpeg invocation
(``video_processing.py:270-297``). The single-device equivalent streams
chunks through one program (``metrics.full_reference``); this module
is the multi-chip variant used by the batched corpus sweep
(``pipeline.sweep.run_sweep_sharded``): the SAME lockstep chunk loop drives
a ``shard_map``'d step (``parallel.sharding.sharded_quality_chunk_step``)
that computes every per-frame quantity (PSNR plane MSEs, x264 SSIM, VIF x4,
ADM2, blurred-luma motion SADs) with the chunk's frame axis sharded over the
mesh; the blur carry crosses chunks (and, inside a chunk, shard boundaries
via a one-frame ``ppermute`` halo). Pooling is shared byte-for-byte with the
streaming engine via ``metrics.full_reference.pool_full_reference``.

Host and device residency is bounded by the chunk size — clips of ANY length
stream, exactly like the single-device engine.
"""

from __future__ import annotations

from typing import Optional

from rtvqa_tpu.io.stream import VideoStream
from rtvqa_tpu.metrics.full_reference import (
    _run_quality_chunks,
    auto_chunk,
    pool_full_reference,
)


def analyze_full_reference_sharded(
    ref_path: str,
    dis_path: str,
    mesh=None,
    vmaf_model_path: Optional[str] = None,
    n_devices: Optional[int] = None,
    chunk: Optional[int] = None,
) -> dict:
    """Full-reference metrics with the frame axis sharded over ``mesh``,
    streaming in bounded-memory chunks (``chunk`` frames per step, rounded
    up to a multiple of the mesh's frame axis; default ``auto_chunk`` scaled
    by the shard count).

    Returns the same dict as ``metrics.full_reference.analyze_full_reference``.
    """
    probe = VideoStream(ref_path, 1, 1)
    w, h = probe.info.width, probe.info.height
    probe.close()
    probe_d = VideoStream(dis_path, 1, 1)
    wd, hd = probe_d.info.width, probe_d.info.height
    probe_d.close()
    if (h, w) != (hd, wd):
        raise ValueError(f"resolution mismatch: {w}x{h} vs {wd}x{hd}")
    if mesh is None:
        import jax

        from rtvqa_tpu.parallel.sharding import make_mesh

        devs = jax.devices()[:n_devices] if n_devices else jax.devices()
        mesh = make_mesh(n_clip=1, n_frame=len(devs), devices=devs)
    chunk = sharded_chunk(mesh, w, h, chunk)
    return full_reference_sharded_batches(
        VideoStream(ref_path, 1, chunk), VideoStream(dis_path, 1, chunk),
        chunk=chunk, mesh=mesh, vmaf_model_path=vmaf_model_path,
    )


def sharded_chunk(mesh, width: int, height: int,
                  chunk: Optional[int] = None) -> int:
    """Frames per sharded step: ``auto_chunk`` is the per-DEVICE memory
    bound and the mesh holds n_shards x that; rounded up to a multiple of
    the mesh's frame axis."""
    n_shards = mesh.devices.shape[-1]
    if chunk is None:
        chunk = auto_chunk(width, height) * n_shards
    return -(-chunk // n_shards) * n_shards


def full_reference_sharded_batches(
    ref_batches,
    dis_batches,
    *,
    chunk: int,
    mesh,
    vmaf_model_path: Optional[str] = None,
) -> dict:
    """``analyze_full_reference_sharded`` over decoded batches of ``chunk``
    frames (``io.stream.FrameBatch``; ``chunk`` from ``sharded_chunk``)."""
    from rtvqa_tpu.parallel.sharding import sharded_quality_chunk_step
    from rtvqa_tpu.vmaf.model import load_model

    model = load_model(vmaf_model_path) if vmaf_model_path else None
    vif_egl = model.vif_enhn_gain_limit if model else None
    adm_egl = model.adm_enhn_gain_limit if model else None
    step = sharded_quality_chunk_step(mesh, vif_egl=vif_egl, adm_egl=adm_egl)

    def runner(ry, ru, rv, dy, du, dv, carry_blur, has_prev):
        packed, blur_lasts = step(ry, ru, rv, dy, du, dv, carry_blur, has_prev)
        return packed, blur_lasts[-1]

    s, n_frames = _run_quality_chunks(
        ref_batches, dis_batches, chunk, vif_egl, adm_egl,
        runner=runner, stage=False,
    )
    if n_frames == 0:
        return {"n_frames": 0}
    return pool_full_reference(s, n_frames, vmaf_model_path, model=model)
