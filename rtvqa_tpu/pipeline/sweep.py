"""Multi-clip CRF-ladder sweep with resumable manifest.

The reference is single-shot (one clip, one CRF per invocation); BASELINE.json
configs[4] calls for a batched CRF ladder (18/23/28/33) over a corpus. Two
drivers share the manifest/CSV semantics:

* ``run_sweep`` — sequential: every (clip, crf) item goes through the
  single-device pipeline (``pipeline.analyzer``);
* ``run_sweep_sharded`` — device-parallel: quality metrics run with the frame
  axis sharded over the mesh (``pipeline.quality_sharded``) and complexity for
  ALL encoded outputs runs as batched sharded programs (clips data-parallel ×
  frames sequence-parallel, ``pipeline.batch_analyzer``). This replaces the
  reference's entire parallelism story (a host process pool over pickled
  frames, ``complexity_metrics.py:128-148``) with XLA collectives.

Both:

* skip items already recorded in the manifest (interrupted sweeps resume by
  skipping done rows — SURVEY.md §5 checkpoint/resume; CSV appends stay
  idempotent);
* isolate failures per item (one bad clip ≠ failed sweep — SURVEY.md §5
  failure-detection row). Only ``io.video.BAD_CLIP_ERRORS`` mark an item
  failed; any other error, such as a device program that fails to lower,
  compile or run, is not a bad clip: it propagates and stops the sweep.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Optional, Sequence

import jax

from rtvqa_tpu.config import Config
from rtvqa_tpu.obs.logging import get_logger

logger = get_logger("rtvqa_tpu.sweep")

DEFAULT_CRF_LADDER = (18, 23, 28, 33)


@dataclasses.dataclass
class SweepManifest:
    """Append-only JSONL manifest keyed by (video, crf)."""

    path: str

    def done_keys(self) -> set[tuple[str, int]]:
        keys = set()
        if os.path.isfile(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("status") == "done":
                        keys.add((rec["video"], int(rec["crf"])))
        return keys

    def record(self, video: str, crf: int, status: str, error: Optional[str] = None) -> None:
        rec = {"video": video, "crf": crf, "status": status}
        if error:
            rec["error"] = error
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def run_sweep(
    videos: Sequence[str],
    config: Config,
    crf_ladder: Iterable[int] = DEFAULT_CRF_LADDER,
    manifest_path: Optional[str] = None,
) -> dict[str, int]:
    """Analyze every (video, crf) pair; returns {'done': n, 'failed': m, 'skipped': k}."""
    from rtvqa_tpu.io import video as vio
    from rtvqa_tpu.pipeline.analyzer import process_video_and_extract_metrics

    manifest = SweepManifest(manifest_path or config.csv_file + ".manifest.jsonl")
    done = manifest.done_keys()
    stats = {"done": 0, "failed": 0, "skipped": 0}

    for video in videos:
        for crf in crf_ladder:
            if (video, int(crf)) in done:
                stats["skipped"] += 1
                continue
            cfg = dataclasses.replace(config, crf=int(crf))
            try:
                process_video_and_extract_metrics(video, cfg)
                manifest.record(video, int(crf), "done")
                stats["done"] += 1
            except vio.BAD_CLIP_ERRORS as e:  # per-item isolation
                logger.error("Sweep item (%s, crf=%d) failed: %s", video, crf, e)
                manifest.record(video, int(crf), "failed", error=str(e))
                stats["failed"] += 1
    return stats


def run_sweep_sharded(
    videos: Sequence[str],
    config: Config,
    crf_ladder: Iterable[int] = DEFAULT_CRF_LADDER,
    manifest_path: Optional[str] = None,
    devices=None,
) -> dict[str, int]:
    """Device-parallel batched sweep (BASELINE configs[4]); same rows/manifest
    as ``run_sweep``.

    Per pending (video, crf) item: encode on the host (in-process libx264),
    then quality metrics with the frame axis sharded over every device, then
    ONE batched sharded complexity program per resolution group covering all
    items at once. ``config.data_parallel_devices`` bounds the mesh size
    (``None`` = all local devices).
    """
    import tempfile

    from rtvqa_tpu.io import video as vio
    from rtvqa_tpu.parallel.sharding import make_mesh
    from rtvqa_tpu.pipeline.analyzer import complexity_columns, quality_columns
    from rtvqa_tpu.pipeline.batch_analyzer import analyze_clips_sharded
    from rtvqa_tpu.pipeline.csv_sink import update_csv
    from rtvqa_tpu.pipeline.quality_sharded import analyze_full_reference_sharded

    manifest = SweepManifest(manifest_path or config.csv_file + ".manifest.jsonl")
    done = manifest.done_keys()
    stats = {"done": 0, "failed": 0, "skipped": 0}

    items: list[tuple[str, int]] = []
    for video in videos:
        for crf in crf_ladder:
            if (video, int(crf)) in done:
                stats["skipped"] += 1
            else:
                items.append((video, int(crf)))
    if not items:
        return stats

    if devices is None:
        devices = jax.devices()
        if config.data_parallel_devices:
            devices = devices[: config.data_parallel_devices]
    n_dev = len(devices)
    quality_mesh = make_mesh(n_clip=1, n_frame=n_dev, devices=devices)
    n_clip = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    comp_mesh = make_mesh(n_clip=n_clip, n_frame=n_dev // n_clip, devices=devices)
    logger.info(
        "Sharded sweep: %d items over %d device(s) (clip=%d x frame=%d complexity mesh)",
        len(items), n_dev, n_clip, n_dev // n_clip,
    )

    failed: dict[tuple[str, int], str] = {}
    rows: dict[tuple[str, int], dict] = {}
    tmp = tempfile.mkdtemp(prefix="rtvqa_sweep_")
    try:
        # --- host encode (sequential; libx264 is the host's job) -----------
        encoded: dict[tuple[str, int], str] = {}
        for video, crf in items:
            out = os.path.join(tmp, f"enc_{len(encoded)}_{crf}.mp4")
            try:
                vio.transcode(video, out, crf=crf, preset=config.preset)
                encoded[(video, crf)] = out
            except vio.BAD_CLIP_ERRORS as e:
                failed[(video, crf)] = f"encode: {e}"

        # --- probe originals once per video --------------------------------
        infos: dict[str, object] = {}
        for video, crf in items:
            if (video, crf) in failed or video in infos:
                continue
            try:
                infos[video] = vio.get_video_info(video)
            except vio.BAD_CLIP_ERRORS as e:
                for v2, c2 in items:
                    if v2 == video and (v2, c2) in encoded:
                        failed[(v2, c2)] = f"probe: {e}"

        live = [it for it in items if it in encoded and it not in failed]
        for video, crf in live:
            info = infos[video]
            rows[(video, crf)] = {
                "Bitrate (kbps)": info.bitrate_kbps,
                "Resolution (px)": info.resolution,
                "Frame Rate (fps)": info.frame_rate,
                "CRF": crf,
            }

        # --- quality: frame-sharded full-reference per item ----------------
        if config.quality_backend == "native":
            for video, crf in live:
                try:
                    qual = analyze_full_reference_sharded(
                        video, encoded[(video, crf)], mesh=quality_mesh,
                        vmaf_model_path=config.vmaf_model_path,
                    )
                    rows[(video, crf)].update(quality_columns(qual, config))
                except vio.BAD_CLIP_ERRORS as e:  # degrade to empty quality cells
                    logger.warning("Quality failed for (%s, crf=%d): %s", video, crf, e)

        # --- complexity: one batched sharded program per resolution group --
        comp_target = {
            it: (it[0] if config.analyze_original else encoded[it]) for it in live
        }
        groups: dict[tuple[int, int], list[tuple[str, int]]] = {}
        for it in live:
            try:
                info = vio.get_video_info(comp_target[it])
                groups.setdefault((info.width, info.height), []).append(it)
            except vio.BAD_CLIP_ERRORS as e:
                failed[it] = f"probe encoded: {e}"
                rows.pop(it, None)

        for res, group in groups.items():
            try:
                results = analyze_clips_sharded(
                    [comp_target[it] for it in group],
                    resize_width=config.resize_width,
                    resize_height=config.resize_height,
                    frame_interval=config.frame_interval,
                    smoothing_factor=config.smoothing_alpha,
                    mesh=comp_mesh,
                    motion_search=config.motion_search,
                )
            except vio.BAD_CLIP_ERRORS as e:
                # Batched call failed: isolate per item sequentially.
                logger.warning("Batched complexity failed for %s: %s", res, e)
                results = []
                for it in group:
                    try:
                        clip = vio.decode_sampled(
                            comp_target[it], frame_interval=config.frame_interval
                        )
                        from rtvqa_tpu.metrics.complexity import (
                            calculate_average_scene_complexity,
                        )

                        results.append(calculate_average_scene_complexity(
                            clip,
                            resize_width=config.resize_width,
                            resize_height=config.resize_height,
                            smoothing_factor=config.smoothing_alpha,
                            motion_search=config.motion_search,
                        ))
                    except vio.BAD_CLIP_ERRORS as e2:
                        failed[it] = f"complexity: {e2}"
                        rows.pop(it, None)
                        results.append(None)
            for it, comp in zip(group, results):
                if comp is None or it not in rows:
                    continue
                rows[it].update(complexity_columns(comp))

        # --- emit rows + manifest in the sequential driver's order ---------
        for it in items:
            video, crf = it
            if it in rows:
                update_csv(rows[it], csv_file=config.csv_file)
                manifest.record(video, crf, "done")
                stats["done"] += 1
            else:
                err = failed.get(it, "unknown failure")
                logger.error("Sweep item (%s, crf=%d) failed: %s", video, crf, err)
                manifest.record(video, crf, "failed", error=err)
                stats["failed"] += 1
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return stats
