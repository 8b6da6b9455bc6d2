"""Unified streaming full-reference engine: PSNR + SSIM + VMAF features in
one pass.

The reference runs one ffmpeg subprocess evaluating psnr, ssim and libvmaf
filter chains over both videos in a single decode pass
(``video_processing.py:270-297``). This is the on-device equivalent: both
videos stream through the native decoder in lockstep batches (prefetched on a
background thread — host decode overlaps device compute) and per chunk the
engine computes every per-frame quantity from two building blocks:

* **program A** (cheap): PSNR plane MSEs (vf_psnr semantics), SSIM Y/U/V/All
  (x264 algorithm), and blurred-luma SADs for VMAF motion/motion2 (a carried
  blurred frame stitches chunk boundaries);
* **program B** (filter-heavy): VIF scales 0-3 + ADM2, plain ``jax.numpy``
  bodies (``vmaf.vif``, ``vmaf.adm``) left to XLA.

On the GPU the two run as ONE program per chunk (``_program_chunk``): one
dispatch and one packed fetch per chunk, with XLA scheduling both phases
inside a single executable. On the CPU the split A/B dispatch is kept: the
merged module compiles several times slower there, and there is no device
to keep busy (``backend.on_gpu``).

Per-frame scalars return to the host; pooling (mean MSE → PSNR, mean SSIM,
per-frame SVR → mean VMAF) happens at the end. Device memory stays bounded
by the chunk size regardless of clip length.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.backend import on_gpu
from rtvqa_tpu.io.stream import VideoStream, prefetch, stage_to_device
from rtvqa_tpu.metrics.quality import psnr_frames, pooled_psnr, ssim_frames
from rtvqa_tpu.obs.logging import get_logger
from rtvqa_tpu.vmaf.adm import adm_features
from rtvqa_tpu.vmaf.filters import filter1d_sep
from rtvqa_tpu.vmaf.model import builtin_model, load_model
from rtvqa_tpu.vmaf.motion import FILTER_5
from rtvqa_tpu.vmaf.vif import vif_features

logger = get_logger("rtvqa_tpu.full_reference")

# Packed row orders (one device->host fetch per program call).
A_KEYS = (
    "mse_y", "mse_u", "mse_v", "mse_avg", "psnr_y", "psnr_avg",
    "ssim_y", "ssim_u", "ssim_v", "ssim_all", "motion_sad",
)
B_KEYS = ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "adm2")
CHUNK_KEYS = A_KEYS + B_KEYS  # combined series key set


@jax.jit
def _program_a(ry, ru, rv, dy, du, dv, prev_blur, has_prev):
    """PSNR + SSIM + motion SADs for one lockstep chunk.

    prev_blur: (H, W) blurred last ref-luma of the previous chunk;
    has_prev: () bool — False for the first chunk (motion[0] = 0).
    Returns (packed (len(A_KEYS), N) float32, new blur carry — stays
    on-device across chunks).
    """
    out = {}
    out.update(psnr_frames(ry, ru, rv, dy, du, dv))
    out.update(ssim_frames(ry, ru, rv, dy, du, dv))
    blur = filter1d_sep(ry.astype(jnp.float32), FILTER_5)
    prev = jnp.concatenate([prev_blur[None], blur[:-1]], axis=0)
    sad = jnp.mean(jnp.abs(blur - prev), axis=(-2, -1))
    sad = sad.at[0].set(jnp.where(has_prev, sad[0], 0.0))
    out["motion_sad"] = sad
    packed = jnp.stack([out[k].astype(jnp.float32) for k in A_KEYS])
    return packed, blur[-1]


@functools.partial(jax.jit, static_argnames=("vif_egl", "adm_egl"))
def _program_b(ry, dy, vif_egl=None, adm_egl=None):
    """VIF (4 scales) + ADM2 for one (sub-)chunk: (len(B_KEYS), N) packed.

    ``vif_egl``/``adm_egl`` are the NEG-mode enhancement-gain limits carried
    by neg model files (``feature_opts_dicts``); None = classic VIF/ADM.
    """
    ryf = ry.astype(jnp.float32)
    dyf = dy.astype(jnp.float32)
    out = {}
    out.update(vif_features(ryf, dyf, enhn_gain_limit=vif_egl))
    out.update(adm_features(ryf, dyf, enhn_gain_limit=adm_egl))
    return jnp.stack([out[k].astype(jnp.float32) for k in B_KEYS])


def _program_chunk_body(ry, ru, rv, dy, du, dv, prev_blur, has_prev,
                        vif_egl=None, adm_egl=None):
    """One program per chunk: PSNR+SSIM+motion AND VIF+ADM.

    One dispatch and one fetch per chunk; XLA schedules both phases inside
    one executable. Returns (packed (len(CHUNK_KEYS), N), new blur carry).
    """
    pa, blur = _program_a(ry, ru, rv, dy, du, dv, prev_blur, has_prev)
    pb = _program_b(ry, dy, vif_egl=vif_egl, adm_egl=adm_egl)
    return jnp.concatenate([pa, pb], axis=0), blur


_program_chunk = functools.partial(
    jax.jit, static_argnames=("vif_egl", "adm_egl")
)(_program_chunk_body)


@functools.partial(
    jax.jit,
    static_argnames=("vif_egl", "adm_egl", "resize_h", "resize_w",
                     "block", "radius", "motion_search", "complexity_on"),
)
def _program_chunk_combined(
    ry, ru, rv, dy, du, dv, prev_blur, has_prev, tail_y, tail_u, tail_v,
    vif_egl=None, adm_egl=None, *,
    resize_h, resize_w, block=16, radius=8, motion_search="pyramid",
    complexity_on="dis",
):
    """Full-suite chunk program: quality AND per-frame complexity values in
    ONE dispatched XLA program — one fetch per chunk.

    The path for the full-suite-per-frame workload (``analyze_combined`` at
    ``frame_interval=1``): it reuses the staged quality planes instead of
    uploading every frame a second time through the ``ComplexityAccumulator``
    tap (the reference pays this workload as one ffmpeg pass PLUS three cv2
    passes — ``video_processing.py:216,233``,
    ``complexity_metrics.py:262,296,520``).

    ``tail_*``: the carried previous sampled frame of the complexity target
    stream (zeros for the first chunk — its slot-0 values are dropped by the
    EWM re-indexing in ``ComplexityAccumulator.finalize``). Returns
    ``(packed (len(CHUNK_KEYS)+7, N), blur_carry, tail_y', tail_u',
    tail_v')`` — carries stay on device across chunks.
    """
    from rtvqa_tpu.metrics.complexity_streaming import _chunk_values_body

    packed_q, blur = _program_chunk_body(
        ry, ru, rv, dy, du, dv, prev_blur, has_prev, vif_egl, adm_egl
    )
    cy, cu, cv = (dy, du, dv) if complexity_on == "dis" else (ry, ru, rv)
    packed_c = _chunk_values_body(
        cy, cu, cv, tail_y, tail_u, tail_v,
        resize_h=resize_h, resize_w=resize_w, block=block, radius=radius,
        motion_search=motion_search,
    )
    packed = jnp.concatenate([packed_q, packed_c], axis=0)
    # Padded tails repeat the last valid frame, so [-1] IS the last valid one.
    return packed, blur, cy[-1], cu[-1], cv[-1]


def auto_chunk(width: int, height: int, requested: Optional[int] = None) -> int:
    """Frames per stream chunk (one program call), scaled to resolution:
    64 frames at 1080p, the same pixel budget at other sizes, at most 128.
    The chunk bounds device memory and host decode latency; it has not been
    re-derived on the GPU yet.
    """
    budget = max(2, int(64 * (1080 * 1920) / max(width * height, 1)))
    budget = min(budget, 128)
    chunk = min(requested or budget, budget)
    return max(2, (chunk // 2) * 2)


def _run_quality_chunks(
    ref_batches,
    dis_batches,
    chunk: int,
    vif_egl,
    adm_egl,
    tap=None,
    runner=None,
    stage: bool = True,
    combined=None,
) -> tuple[dict, int]:
    """The shared streaming loop over two iterables of decoded ``FrameBatch``
    of ``chunk`` frames (``io.stream.VideoStream(path, 1, chunk)``, or
    batches made in memory): walk both once in lockstep, stage full chunks
    into device memory from the prefetch threads (one
    explicit ``device_put`` per plane, overlapped with compute, instead of
    jit's implicit upload per program), run ONE metric program per chunk,
    return (per-frame series, n_frames).

    ``tap(db_host_batch, n, global_offset)`` — optional callback fired per
    chunk with the decoded host batches (the combined engine's complexity
    sampling hook).

    ``runner(ry..dv, prev_blur, has_prev) -> (packed, blur_carry)`` —
    optional chunk program override (the multi-chip sharded step,
    ``pipeline.quality_sharded``); ``stage=False`` skips single-device
    staging for runners that place data themselves (a shard_map'd jit
    re-shards its inputs across the mesh).

    ``combined`` — optional ``ComplexityAccumulator``-driven merged mode
    (``{"acc": ComplexityAccumulator, "complexity_on": "dis"|"ref"}``): every
    frame also runs the complexity value program INSIDE the quality chunk
    program (``_program_chunk_combined``, one dispatch + one fetch per chunk);
    per-frame values land in the accumulator via ``add_packed``. The
    ``frame_interval=1`` fast path of ``analyze_combined``: it reuses the
    staged quality planes and fetches ONE packed array, where the tap path
    uploads every sampled frame again and dispatches a second program
    family. Mutually exclusive with ``tap``/``runner``.
    """
    stage_chunk = chunk if stage else None
    ref_it = prefetch(stage_to_device(ref_batches, stage_chunk), depth=1)
    dis_it = prefetch(stage_to_device(dis_batches, stage_chunk), depth=1)

    try:
        return _quality_chunk_loop(
            ref_it, dis_it, chunk, vif_egl, adm_egl, tap, runner, combined,
        )
    finally:
        # Close on ANY exit: an exception mid-chunk must not leave the
        # prefetch producer threads and decoder contexts alive until GC
        # finalizes the generators.
        ref_it.close()
        dis_it.close()


def _quality_chunk_loop(ref_it, dis_it, chunk, vif_egl, adm_egl, tap,
                        runner=None, combined=None):
    """Run the chunk programs over two iterators of ``StagedFrameBatch``
    (``io.stream.stage_to_device``); see ``_run_quality_chunks``."""
    series: dict[str, list[np.ndarray]] = {}
    carry_blur = None
    first = True
    n_frames = 0
    tails = None  # merged mode: carried complexity tail frames (on device)

    # Depth-1 fetch pipeline: chunk k's packed outputs are materialized
    # only after chunk k+1's program is DISPATCHED, so the small fetch
    # overlaps the in-flight execution instead of serializing with it. The
    # device carries (blur, tails) feed the next dispatch WITHOUT
    # materialization, so only the packed fetch is deferred; at most two
    # chunk programs are in flight.
    pending = None  # (packed_dev_or_host, n, timestamps_or_None)

    def flush(acc=None):
        # A double flush is a no-op by construction: pending is consumed
        # here, not at the call sites.
        nonlocal n_frames, pending
        if pending is None:
            return
        packed_h, pn, ts = pending
        pending = None
        packed_h = np.asarray(packed_h)
        if acc is not None:
            acc.add_packed(packed_h[len(CHUNK_KEYS):, :pn], ts)
            packed_h = packed_h[: len(CHUNK_KEYS)]
        for row, k in enumerate(CHUNK_KEYS):
            series.setdefault(k, []).append(packed_h[row, :pn])
        n_frames += pn

    while True:
        rb = next(ref_it, None)
        db = next(dis_it, None)
        if rb is None or db is None:
            break
        rhost, dhost = rb.host, db.host
        n = min(rhost.y.shape[0], dhost.y.shape[0])
        if n == 0:
            break
        pad = chunk - n

        if pad == 0 and rb.y is not None and db.y is not None:
            # Full lockstep chunk: planes already staged on the device.
            ry, ru, rv = rb.y, rb.u, rb.v
            dy, du, dv = db.y, db.u, db.v
        else:
            def prep(a, n=n, pad=pad):
                a = a[:n]
                return np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)

            ry, ru, rv = prep(rhost.y), prep(rhost.u), prep(rhost.v)
            dy, du, dv = prep(dhost.y), prep(dhost.u), prep(dhost.v)

        if carry_blur is None:
            carry_blur = np.zeros(rhost.y.shape[1:], np.float32)
        if combined is not None:
            acc = combined["acc"]
            on_dis = combined.get("complexity_on", "dis") == "dis"
            if tails is None:
                tails = (
                    np.zeros(rhost.y.shape[1:], rhost.y.dtype),
                    np.zeros(rhost.u.shape[1:], rhost.u.dtype),
                    np.zeros(rhost.v.shape[1:], rhost.v.dtype),
                )
            packed, carry_blur, *tails = _program_chunk_combined(
                ry, ru, rv, dy, du, dv, carry_blur, jnp.asarray(not first),
                *tails, vif_egl=vif_egl, adm_egl=adm_egl,
                resize_h=acc.resize_height, resize_w=acc.resize_width,
                block=acc.block, radius=acc.radius,
                motion_search=acc.motion_search,
                complexity_on="dis" if on_dis else "ref",
            )
            chost = dhost if on_dis else rhost
            flush(acc)  # chunk k-1's ONE fetch, after chunk k's dispatch
            pending = (packed, n, chost.timestamps_ms[:n])
        elif runner is not None:
            packed, carry_blur = runner(
                ry, ru, rv, dy, du, dv, carry_blur, jnp.asarray(not first)
            )
            flush()
            pending = (packed, n, None)
        elif on_gpu():
            # One program per chunk: one dispatch + one (deferred) fetch.
            packed, carry_blur = _program_chunk(
                ry, ru, rv, dy, du, dv, carry_blur, jnp.asarray(not first),
                vif_egl=vif_egl, adm_egl=adm_egl,
            )
            flush()
            pending = (packed, n, None)
        else:
            # CPU: the merged module takes several times longer to compile
            # than the two halves, and there is no device to keep busy —
            # keep the split dispatch, no deferral.
            pa, carry_blur = _program_a(
                ry, ru, rv, dy, du, dv, carry_blur, jnp.asarray(not first)
            )
            pa = np.asarray(pa)
            pb = np.asarray(_program_b(ry, dy, vif_egl=vif_egl, adm_egl=adm_egl))
            flush()
            pending = (np.concatenate([pa, pb], axis=0), n, None)

        if tap is not None:
            # n_frames counts flushed chunks 0..k-1 — this chunk's offset.
            tap(rhost, dhost, n, n_frames)

        first = False
        if rhost.y.shape[0] != dhost.y.shape[0]:
            break  # one stream ended mid-batch: stop at the common prefix

    flush(combined["acc"] if combined is not None and pending is not None
          else None)
    return {k: np.concatenate(v) for k, v in series.items()}, n_frames


def analyze_full_reference(
    ref_path: str,
    dis_path: str,
    chunk: Optional[int] = None,
    vmaf_model_path: Optional[str] = None,
) -> dict:
    """Stream both videos once; return pooled PSNR/SSIM/VMAF + per-frame series."""
    probe = VideoStream(ref_path, 1, 1)
    chunk = auto_chunk(probe.info.width, probe.info.height, chunk)
    probe.close()
    # Load the model up-front: NEG variants carry extractor options
    # (enhancement-gain limits) that change the feature programs themselves.
    model = load_model(vmaf_model_path) if vmaf_model_path else None
    s, n_frames = _run_quality_chunks(
        VideoStream(ref_path, 1, chunk), VideoStream(dis_path, 1, chunk), chunk,
        model.vif_enhn_gain_limit if model else None,
        model.adm_enhn_gain_limit if model else None,
    )
    if n_frames == 0:
        return {"n_frames": 0}
    return pool_full_reference(s, n_frames, vmaf_model_path, model=model)


def analyze_combined(
    ref_path: str,
    dis_path: str,
    *,
    chunk: Optional[int] = None,
    **kwargs,
) -> tuple[dict, "object"]:
    """One decode pass per stream: full-reference quality AND the eight-metric
    complexity suite from the same lockstep loop.

    The reference decodes the encoded clip once for ffmpeg's quality filters
    and three more times for complexity (``video_processing.py:216+233``,
    ``complexity_metrics.py:262,520,296`` — SURVEY.md §2.4(3)); this engine
    reaches the two-pass minimum. Keyword arguments are those of
    ``analyze_combined_batches``. Returns ``(quality_dict, ComplexityResult)``.
    """
    _resolve_merged(kwargs.get("merged"), kwargs.get("frame_interval", 10))
    probe = VideoStream(ref_path, 1, 1)
    chunk = auto_chunk(probe.info.width, probe.info.height, chunk)
    probe.close()
    return analyze_combined_batches(
        VideoStream(ref_path, 1, chunk), VideoStream(dis_path, 1, chunk),
        chunk=chunk, **kwargs,
    )


def _resolve_merged(merged: Optional[bool], frame_interval: int) -> bool:
    if merged is None:
        return frame_interval == 1 and on_gpu()
    if merged and frame_interval != 1:
        raise ValueError(
            "merged=True requires frame_interval=1 (every frame feeds the "
            f"combined chunk program); got frame_interval={frame_interval}"
        )
    return merged


def analyze_combined_batches(
    ref_batches,
    dis_batches,
    *,
    chunk: int,
    frame_interval: int = 10,
    resize_width: int = 64,
    resize_height: int = 64,
    smoothing_factor: float = 0.8,
    complexity_chunk: int = 32,
    complexity_on: str = "dis",
    vmaf_model_path: Optional[str] = None,
    motion_search: str = "pyramid",
    merged: Optional[bool] = None,
) -> tuple[dict, "object"]:
    """``analyze_combined`` over decoded batches of ``chunk`` frames
    (``io.stream.FrameBatch``; see ``_run_quality_chunks``).

    Every ``frame_interval``-th frame of the complexity target stream
    (``complexity_on``: 'dis' = encoded clip, the reference default; 'ref' =
    the analyze_original mode) is tapped out of the quality loop into a
    ``ComplexityAccumulator`` (identical chunking/pooling to the streaming
    driver — equivalence tested).

    ``merged``: run complexity INSIDE the quality chunk program
    (``_program_chunk_combined`` — one dispatch + one fetch per chunk instead
    of two program families). Only applicable at ``frame_interval=1`` (every
    frame feeds both); ``None`` = auto (on whenever applicable on the GPU;
    off on the CPU, where the merged module compiles slower).
    """
    from rtvqa_tpu.metrics.complexity_streaming import ComplexityAccumulator

    merged = _resolve_merged(merged, frame_interval)
    model = load_model(vmaf_model_path) if vmaf_model_path else None

    acc = ComplexityAccumulator(
        resize_width, resize_height, smoothing_factor, complexity_chunk,
        motion_search=motion_search,
    )

    def tap(rhost, dhost, n, offset):
        # Sampled frames for complexity out of this already-decoded chunk
        # (1-based sampling: global frames k-1, 2k-1, … — decode_sampled
        # semantics, SURVEY.md §2.4(4) unified).
        cb = dhost if complexity_on == "dis" else rhost
        gidx = np.arange(offset, offset + n)
        keep = (gidx + 1) % frame_interval == 0
        if keep.any():
            acc.add(
                cb.y[:n][keep], cb.u[:n][keep], cb.v[:n][keep],
                cb.timestamps_ms[:n][keep],
            )

    s, n_frames = _run_quality_chunks(
        ref_batches, dis_batches, chunk,
        model.vif_enhn_gain_limit if model else None,
        model.adm_enhn_gain_limit if model else None,
        tap=None if merged else tap,
        combined={"acc": acc, "complexity_on": complexity_on} if merged else None,
    )
    comp = acc.finalize()
    if n_frames == 0:
        return {"n_frames": 0}, comp
    return pool_full_reference(s, n_frames, vmaf_model_path, model=model), comp


def pool_full_reference(
    s: dict[str, np.ndarray],
    n_frames: int,
    vmaf_model_path: Optional[str] = None,
    model=None,
) -> dict:
    """Pool per-frame series (keys ``CHUNK_KEYS``, each (n_frames,)) into the
    final metrics dict. Shared by the streaming single-device engine above and
    the sharded multi-chip step (``pipeline.quality_sharded``) so both paths
    pool identically (PSNR mean-MSE pooling, motion2 min rule, SVR predict).
    """
    valid = np.ones(n_frames, bool)
    psnr = float(np.asarray(pooled_psnr(jnp.asarray(s["mse_avg"]), jnp.asarray(valid))))
    ssim = float(np.mean(s["ssim_all"]))

    # motion2[t] = min(sad[t], sad[t+1]); last frame keeps its backward SAD.
    sad = s["motion_sad"]
    fwd = np.concatenate([sad[1:], [np.inf]])
    motion2 = np.minimum(sad, fwd)
    motion2[0] = 0.0

    feats = {
        "adm2": s["adm2"],
        "motion2": motion2.astype(np.float32),
        "vif_scale0": s["vif_scale0"],
        "vif_scale1": s["vif_scale1"],
        "vif_scale2": s["vif_scale2"],
        "vif_scale3": s["vif_scale3"],
    }
    vmaf_is_fallback = model is None and not vmaf_model_path
    if model is None and vmaf_model_path:
        model = load_model(vmaf_model_path)
    if model is None:
        model = builtin_model()
        logger.warning(
            "No VMAF model file given; using %s — scores are qualitative, not "
            "libvmaf-parity. Provide vmaf_v0.6.1.json via vmaf_model_path.",
            model.name,
        )
    vmaf_per_frame = np.asarray(model.predict(feats))

    return {
        "n_frames": n_frames,
        "psnr": psnr,
        "ssim": ssim,
        "vmaf": float(vmaf_per_frame.mean()),
        "per_frame": {
            "psnr": s["psnr_avg"],
            "ssim": s["ssim_all"],
            "vmaf": vmaf_per_frame,
            **feats,
        },
        "vmaf_model": model.name,
        # True when the score came from the invented builtin fallback rather
        # than a real libvmaf model file — consumers must not present it as a
        # libvmaf-parity VMAF (the CSV sink leaves the cell empty by default).
        "vmaf_is_fallback": vmaf_is_fallback,
    }
