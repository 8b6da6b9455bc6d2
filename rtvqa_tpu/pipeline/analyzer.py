"""Single-clip orchestrator: encode → analyze → one CSV row.

On-device rebuild of ``process_video_and_extract_metrics``
(``video_processing.py:180-267``):

1. transcode the input with in-process libx264 at the configured CRF/preset
   (reference: ffmpeg subprocess, ``:200-214``);
2. probe the original's bitrate/resolution/fps natively (reference: ffprobe
   subprocess + ``eval()``, ``:101-142``);
3. decode ONCE per stream and run PSNR/SSIM/VMAF on-device over every frame
   (reference: a second ffmpeg subprocess with psnr/ssim/libvmaf filters +
   regex log scraping, ``:270-297`` / ``:145-177``);
4. run the eight-metric complexity suite on the *encoded* clip's sampled
   frames (reference ``:233-247``; set ``analyze_original=True`` to analyze
   the source instead — SURVEY.md §2.4(5));
5. append the 15-column CSV row — with the tuple-order bug corrected
   (SURVEY.md §2.4(1)): each complexity column holds the metric its header
   names.

Failure semantics mirror the reference: quality metrics that fail on a bad
clip (``io.video.BAD_CLIP_ERRORS``) degrade to empty CSV cells
(``:156-175``); every other error, such as a device program that fails to
lower, compile or run, propagates, so a broken device is never reported as a
clip with no scores. Temp artifacts are cleaned in
``finally`` (``:263-267``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

from rtvqa_tpu.config import Config
from rtvqa_tpu.io import video as vio
from rtvqa_tpu.metrics.complexity import calculate_average_scene_complexity
from rtvqa_tpu.obs.logging import get_logger
from rtvqa_tpu.obs.profiler import StageTimer
from rtvqa_tpu.pipeline.csv_sink import update_csv

logger = get_logger("rtvqa_tpu.pipeline")


def quality_columns(qual: dict, config: Config) -> dict[str, Any]:
    """PSNR/SSIM/VMAF CSV cells from a pooled quality dict (empty when the
    pair had no frames; VMAF empty for the builtin fallback model unless
    ``allow_builtin_vmaf``)."""
    if qual["n_frames"] == 0:
        return {}
    cols = {"PSNR": qual["psnr"], "SSIM": qual["ssim"]}
    if not qual["vmaf_is_fallback"] or config.allow_builtin_vmaf:
        cols["VMAF"] = qual["vmaf"]
    else:
        # Artifact-level honesty: a CSV consumer cannot tell a fallback
        # score from a libvmaf-parity one, so the cell stays empty unless
        # explicitly opted in.
        logger.warning(
            "VMAF cell left empty: no model file. Set vmaf_model_path "
            "(libvmaf JSON) for parity scores or allow_builtin_vmaf=true for "
            "the qualitative builtin fallback.",
        )
    return cols


def complexity_columns(comp) -> dict[str, float]:
    """The eight complexity CSV cells, each under the header that names its
    metric (the reference's label<->value mix-up, SURVEY.md §2.4(1), is
    corrected)."""
    return {
        "Advanced Motion Complexity": comp.motion,
        "DCT Complexity": comp.dct,
        "Temporal DCT Complexity": comp.temporal_dct,
        "Histogram Complexity": comp.histogram,
        "Edge Detection Complexity": comp.edge,
        "ORB Feature Complexity": comp.orb,
        "Color Histogram Complexity": comp.color,
        "Framerate Variation": comp.framerate,
    }


def analyze_video(
    input_video: str, config: Config, timer: StageTimer | None = None
) -> dict[str, Any]:
    """Run the full pipeline for one clip; returns the CSV-row metrics dict.

    ``timer`` (optional) accumulates per-stage wall clock + a frames/sec
    counter (SURVEY.md §5 tracing row); when omitted a local one is created
    and its summary is emitted to the log at the end.
    """
    if not os.path.isfile(input_video):
        raise FileNotFoundError(f"The input video file {input_video} does not exist.")

    own_timer = timer is None
    timer = timer or StageTimer()
    temp_dir = tempfile.mkdtemp(prefix="rtvqa_")
    try:
        encoded_video = os.path.join(temp_dir, "encoded_video.mp4")
        logger.info("Encoding %s at CRF %d (%s)", input_video, config.crf, config.preset)
        with timer.stage("encode"):
            vio.transcode(input_video, encoded_video, crf=config.crf, preset=config.preset)

        with timer.stage("probe"):
            info = vio.get_video_info(input_video)
        metrics: dict[str, Any] = {
            "Bitrate (kbps)": info.bitrate_kbps,
            "Resolution (px)": info.resolution,
            "Frame Rate (fps)": info.frame_rate,
            "CRF": config.crf,
        }

        comp = None
        # streaming_complexity=False explicitly opts out of streaming paths →
        # keep quality and complexity separate (legacy fused complexity).
        # Otherwise the combined engine computes quality AND complexity from
        # ONE decode pass per stream (the two-pass minimum; the reference
        # decodes four times total — SURVEY.md §2.4(3)).
        use_combined = (
            config.quality_backend == "native" and config.streaming_complexity is not False
        )
        if config.quality_backend == "native":
            try:
                logger.info("Computing native PSNR/SSIM/VMAF (full-res, every frame)")
                if use_combined:
                    from rtvqa_tpu.metrics.full_reference import analyze_combined

                    with timer.stage("quality+complexity"):
                        qual, comp = analyze_combined(
                            input_video,
                            encoded_video,
                            frame_interval=config.frame_interval,
                            resize_width=config.resize_width,
                            resize_height=config.resize_height,
                            smoothing_factor=config.smoothing_alpha,
                            complexity_chunk=config.batch_size,
                            complexity_on="ref" if config.analyze_original else "dis",
                            vmaf_model_path=config.vmaf_model_path,
                            motion_search=config.motion_search,
                        )
                else:
                    from rtvqa_tpu.metrics.full_reference import analyze_full_reference

                    with timer.stage("quality"):
                        qual = analyze_full_reference(
                            input_video,
                            encoded_video,
                            vmaf_model_path=config.vmaf_model_path,
                        )
                timer.add_frames(int(qual.get("n_frames", 0)))
                if qual["n_frames"] == 0:
                    comp = None  # degenerate pair: recompute via legacy path
                metrics.update(quality_columns(qual, config))
            except vio.BAD_CLIP_ERRORS as e:  # degrade like the reference
                logger.warning("Quality metrics failed: %s", e)
                comp = None

        if comp is None:
            logger.info("Calculating scene complexity after encoding...")
            target = input_video if config.analyze_original else encoded_video
            use_streaming = config.streaming_complexity
            if use_streaming is None:  # auto: stream when the file is large
                use_streaming = os.path.getsize(target) > 256 * 1024 * 1024
            if use_streaming:
                from rtvqa_tpu.metrics.complexity_streaming import (
                    calculate_average_scene_complexity_streaming,
                )

                with timer.stage("complexity"):
                    comp = calculate_average_scene_complexity_streaming(
                        target,
                        resize_width=config.resize_width,
                        resize_height=config.resize_height,
                        frame_interval=config.frame_interval,
                        smoothing_factor=config.smoothing_alpha,
                        chunk=config.batch_size,
                        motion_search=config.motion_search,
                    )
            else:
                with timer.stage("decode"):
                    clip = vio.decode_sampled(
                        target, frame_interval=config.frame_interval, threads=config.num_workers
                    )
                with timer.stage("complexity"):
                    comp = calculate_average_scene_complexity(
                        clip,
                        resize_width=config.resize_width,
                        resize_height=config.resize_height,
                        smoothing_factor=config.smoothing_alpha,
                        motion_search=config.motion_search,
                    )

        metrics.update(complexity_columns(comp))
        logger.info("Metrics extracted: %s", metrics)
        if own_timer:
            timer.log_summary()
        return metrics
    finally:
        shutil.rmtree(temp_dir, ignore_errors=True)


def process_video_and_extract_metrics(
    input_video: str, config: Config, timer: StageTimer | None = None
) -> dict[str, Any]:
    """analyze + CSV append (the reference L6 entry point's full behavior)."""
    metrics = analyze_video(input_video, config, timer=timer)
    update_csv(metrics, csv_file=config.csv_file)
    return metrics
