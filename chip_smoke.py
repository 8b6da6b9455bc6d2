"""Smoke test of the full metric suite on one NVIDIA GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded CRF-ladder sweep only

Phases (one GPU), all in this process except the first pytest run:

1. the card's name and power limit (``nvidia-smi``); the FFmpeg libraries the
   native IO layer links against, and a build of ``native/`` when they exist;
2. ``pytest -m gpu tests/`` in a subprocess (``JAX_PLATFORMS=cuda``), before
   this process touches the card;
3. compile ``_program_chunk``, ``_program_chunk_combined`` and
   ``complexity_suite_packed`` at 1080p, chunk 64, and print each one's
   ``memory_analysis()``;
4. 8 frame pairs of the seeded 1080p clip against the float64 oracles of
   ``tests/oracles`` (PSNR, SSIM, VIF 0-3, ADM2, VMAF motion SAD, the eight
   complexity values), each within the repository's own limit, and the
   motion search kernel against the XLA scan;
5. the normal entry points on a seeded 1080p, 30 fps, 130-frame clip: the CLI
   at ``frame_interval`` 1 and 10 and with ``--sweep 23 33``, checking the
   CSV rows. Where the FFmpeg libraries are missing, decode cannot run: the
   same frames go through the same chunk loop as decoded batches instead.

``--four`` runs the frame-sharded sweep (``--sweep 18 23 28 33``) on a
("clip", "frame") mesh of four GPUs and compares it with the same sweep on
one GPU, in this process.

The last line of standard output is one JSON object naming the device; the
script exits non-zero, without that line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import ctypes.util
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FFMPEG_LIBS = ("avcodec", "avformat", "avutil", "swscale", "x264")


@dataclasses.dataclass(frozen=True)
class Size:
    """Clip geometry the phases run at."""

    h: int = 1080
    w: int = 1920
    frames: int = 130   # two full 64-frame chunks and a ragged tail
    fps: int = 30
    chunk: int = 64     # auto_chunk(1920, 1080)
    oracle_pairs: int = 8


FULL = Size()


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    log(f"ok: {what}")


# ---------------------------------------------------------------------------
# Phase 1: the machine
# ---------------------------------------------------------------------------


def require_gpu_machine() -> str:
    """Refuse to start anywhere but a GPU machine with the repository; returns
    the ``nvidia-smi`` name/power-limit line."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not {"cuda", "gpu"} & set(platforms.split(",")):
        raise SmokeFailure(f"JAX_PLATFORMS={platforms!r} excludes the GPU")
    if not os.path.isdir(os.path.join(REPO, "rtvqa_tpu")):
        raise SmokeFailure(f"no rtvqa_tpu package next to {__file__}")
    if shutil.which("nvidia-smi") is None:
        raise SmokeFailure("nvidia-smi not found: no NVIDIA GPU here")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def native_io_available() -> bool:
    """True when the FFmpeg libraries are present and ``native/`` builds."""
    found = {name: ctypes.util.find_library(name) for name in FFMPEG_LIBS}
    log(f"FFmpeg libraries: {found}")
    missing = [name for name, path in found.items() if path is None]
    if missing:
        log(f"decode not run: lib{', lib'.join(missing)} not found on this "
            "machine, so native/ cannot be built; phase 5 feeds seeded "
            "decoded-frame batches through the same chunk loop")
        return False
    proc = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SmokeFailure(f"native/ build failed:\n{proc.stdout}{proc.stderr}")
    log("native/ built from source")
    return True


# ---------------------------------------------------------------------------
# Phase 2: card-marked tests
# ---------------------------------------------------------------------------


def run_gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", "tests/"],
        cwd=REPO, env=env,
    )
    check(proc.returncode == 0, f"pytest -m gpu tests/ (rc={proc.returncode})")


# ---------------------------------------------------------------------------
# Seeded clip
# ---------------------------------------------------------------------------


def make_clip(size: Size, seed: int = 0):
    """Seeded camera-like RGB frames as planar YUV420 (the encoder's input):
    a drifting smooth pattern, moving blocks and a fixed texture panned
    across the frame. Returns (y, u, v, timestamps_ms)."""
    import numpy as np

    from rtvqa_tpu.ops.color import rgb_to_yuv420_np

    h, w = size.h, size.w
    rng = np.random.default_rng(seed)
    texture = rng.integers(-12, 13, (h, w + 4 * size.frames)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = np.empty((size.frames, h, w), np.uint8)
    u = np.empty((size.frames, h // 2, w // 2), np.uint8)
    v = np.empty((size.frames, h // 2, w // 2), np.uint8)
    for i in range(size.frames):
        base = (120.0 + 50.0 * np.sin(2 * np.pi * (xx + 3.0 * i) / (w / 6))
                + 30.0 * np.cos(2 * np.pi * (yy + 2.0 * i) / (h / 5)))
        base += texture[:, 4 * i: 4 * i + w]
        bh, bw = max(h // 8, 2), max(w // 8, 2)
        by, bx = (h // 5 + 3 * i) % (h - bh), (w // 7 + 5 * i) % (w - bw)
        base[by:by + bh, bx:bx + bw] = 235.0
        rgb = np.stack([base, 0.8 * base + 25.0, 255.0 - base], -1)
        yi, ui, vi = rgb_to_yuv420_np(np.clip(rgb, 0, 255)[None])
        y[i], u[i], v[i] = yi[0], ui[0], vi[0]
    ts = np.arange(size.frames) * (1000.0 / size.fps)
    return y, u, v, ts


def distort(planes, crf: int, seed: int):
    """A coding-like distortion of the seeded planes whose strength grows
    with ``crf``: rounding noise of amplitude ~ crf/6 on every plane."""
    import numpy as np

    rng = np.random.default_rng(seed)
    amp = max(1, crf // 6)
    out = []
    for p in planes:
        noise = rng.integers(-amp, amp + 1, p.shape, dtype=np.int16)
        out.append(np.clip(p.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return tuple(out)


def frame_batches(planes, ts, chunk: int):
    """Decoded-frame batches of ``chunk`` frames, as ``VideoStream`` yields."""
    from rtvqa_tpu.io.stream import FrameBatch

    y, u, v = planes
    for start in range(0, y.shape[0], chunk):
        sl = slice(start, start + chunk)
        yield FrameBatch(y[sl], u[sl], v[sl], ts[sl], start)


# ---------------------------------------------------------------------------
# Phase 3: compile at full size
# ---------------------------------------------------------------------------


def compile_programs(size: Size) -> None:
    import jax
    import jax.numpy as jnp

    from rtvqa_tpu.metrics.complexity import complexity_suite_packed
    from rtvqa_tpu.metrics.full_reference import (
        _program_chunk, _program_chunk_combined,
    )

    n, h, w = size.chunk, size.h, size.w
    y = jax.ShapeDtypeStruct((n, h, w), jnp.uint8)
    c = jax.ShapeDtypeStruct((n, h // 2, w // 2), jnp.uint8)
    blur = jax.ShapeDtypeStruct((h, w), jnp.float32)
    flag = jax.ShapeDtypeStruct((), jnp.bool_)
    ty = jax.ShapeDtypeStruct((h, w), jnp.uint8)
    tc = jax.ShapeDtypeStruct((h // 2, w // 2), jnp.uint8)
    ts = jax.ShapeDtypeStruct((n,), jnp.float32)
    nv = jax.ShapeDtypeStruct((), jnp.int32)
    programs = {
        "_program_chunk": lambda: _program_chunk.lower(
            y, c, c, y, c, c, blur, flag),
        "_program_chunk_combined": lambda: _program_chunk_combined.lower(
            y, c, c, y, c, c, blur, flag, ty, tc, tc, resize_h=64, resize_w=64),
        "complexity_suite_packed": lambda: complexity_suite_packed.lower(
            y, c, c, ts, nv, resize_h=64, resize_w=64),
    }
    for name, lower in programs.items():
        t0 = time.perf_counter()
        compiled = lower().compile()
        m = compiled.memory_analysis()
        stats = {k: getattr(m, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}
        log(f"compiled {name} at {n}x{h}x{w} in "
            f"{time.perf_counter() - t0:.1f}s: memory_analysis {stats}")


# ---------------------------------------------------------------------------
# Phase 4: float64 oracles
# ---------------------------------------------------------------------------


def _quality_oracle(ref, dis):
    """Per-frame float64 oracle values for one (ref, dis) YUV frame pair."""
    import numpy as np

    from rtvqa_tpu.vmaf.vif import vif_features_np
    from tests.oracles import adm as adm_oracle
    from tests.oracles import quality as q_oracle

    p = q_oracle.psnr_frame(ref, dis)
    s = q_oracle.ssim_frame(ref, dis)
    out = {
        "psnr_y": 10 * np.log10(255.0 ** 2 / p["mse_y"]),
        "psnr_avg": 10 * np.log10(255.0 ** 2 / p["mse_avg"]),
        **{k: s[k] for k in ("ssim_y", "ssim_u", "ssim_v", "ssim_all")},
        **vif_features_np(ref[0], dis[0]),
        "adm2": adm_oracle.adm2(ref[0], dis[0]),
    }
    return out


def _blur_oracle(luma):
    from rtvqa_tpu.vmaf.filters import filter1d_sep_np
    from rtvqa_tpu.vmaf.motion import FILTER_5

    return filter1d_sep_np(luma, FILTER_5)


def _complexity_oracle(prev_gray, gray, gray_rs_prev, gray_rs, rgb_rs, dt_ms):
    """Float64 oracle values of one sampled pair, fed the same arrays as the
    ops on the card (as the op-level oracle tests do)."""
    import numpy as np

    from rtvqa_tpu.ops.orb import pyramid_shapes
    from rtvqa_tpu.ops.resize import resize_bilinear_np
    from tests.oracles import complexity as c_oracle
    from tests.oracles import orb as orb_oracle

    u8 = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)  # noqa: E731
    gray_rs_i = np.round(gray_rs)
    levels = [gray_rs_i if s == gray_rs.shape else resize_bilinear_np(gray_rs_i, *s)
              for s in pyramid_shapes(*gray_rs.shape, 8, 1.2)]
    return {
        "motion": c_oracle.block_match_motion_pyramid(
            np.round(prev_gray), np.round(gray), 16, 8),
        "dct": c_oracle.dct_energy(gray_rs),
        "histogram": c_oracle.gray_entropy(u8(gray_rs)),
        "edge": float(c_oracle.canny(gray_rs_i).sum()),
        "orb": float(min(500, sum(
            orb_oracle.fast_keypoint_count(lv, 20.0, 31) for lv in levels))),
        "color": c_oracle.color_entropy(u8(np.moveaxis(rgb_rs, 0, -1))),
        "temporal_dct": c_oracle.temporal_dct(gray_rs_prev, gray_rs),
        "framerate": 1000.0 / dt_ms if dt_ms > 0 else 0.0,
    }


#: (kind, limit): "abs" or "rel" error allowed against the float64 oracle —
#: the repository's own limits (docs/PARITY.md; tests/test_complexity_ops.py).
QUALITY_LIMITS = {
    "psnr_y": ("abs", 1e-4), "psnr_avg": ("abs", 1e-4),
    "ssim_y": ("abs", 1e-4), "ssim_u": ("abs", 1e-4), "ssim_v": ("abs", 1e-4),
    "ssim_all": ("abs", 1e-4),
    "vif_scale0": ("rel", 3e-4), "vif_scale1": ("rel", 3e-4),
    "vif_scale2": ("rel", 3e-4), "vif_scale3": ("rel", 3e-4),
    "adm2": ("rel", 3e-4), "motion_sad": ("rel", 1e-5),
}
COMPLEXITY_LIMITS = {
    "motion": ("rel", 1e-6), "dct": ("rel", 1e-5), "histogram": ("abs", 1e-4),
    "edge": ("abs", 0.0), "orb": ("abs", 0.0), "color": ("abs", 1e-3),
    "temporal_dct": ("rel", 1e-4), "framerate": ("rel", 1e-5),
}


#: A block's f32 SAD sums block**2 terms, so its rounding error is at most
#: ~64 * 2**-24 = 3.8e-6 of the SAD at block 8; a choice can miss the float64
#: minimum by twice that. Anything further is a wrong displacement.
MOTION_SAD_TIE_REL = 1e-5


def _sad_excess(prev, curr, dy, dx, block, radius) -> float:
    """How far the chosen displacements' float64 SADs exceed each block's
    float64 minimum over every candidate, relative to that minimum (max over
    blocks). ``dy``/``dx``: (nby, nbx) fields of one frame pair."""
    import numpy as np

    h, w = curr.shape
    hb, wb = (h // block) * block, (w // block) * block
    nby, nbx = hb // block, wb // block
    c = curr[:hb, :wb].astype(np.float64)
    p = np.pad(prev[:hb, :wb].astype(np.float64), radius, mode="edge")
    side = 2 * radius + 1
    sads = np.stack([
        np.abs(c - p[oy:oy + hb, ox:ox + wb])
        .reshape(nby, block, nbx, block).sum(axis=(1, 3))
        for oy in range(side) for ox in range(side)])
    k = ((dy + radius) * side + (dx + radius)).astype(np.int64)
    chosen = np.take_along_axis(sads, k[None], axis=0)[0]
    best = sads.min(axis=0)
    return float(((chosen - best) / np.maximum(best, 1e-12)).max())


def _compare(name, got, want, kind, limit) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    if kind == "rel":
        err = err / np.maximum(np.abs(want), 1e-12)
    worst = float(err.max())
    check(worst <= limit, f"{name}: max {kind} err {worst:.3g} <= {limit:g}")
    return worst


def oracle_phase(size: Size, ref, dis, ts, pool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtvqa_tpu.metrics.full_reference import CHUNK_KEYS, _program_chunk
    from rtvqa_tpu.ops.color import yuv420_to_gray, yuv420_to_rgb_planes
    from rtvqa_tpu.ops.dct import dct_energy, temporal_dct_abs_diff
    from rtvqa_tpu.ops.edges import canny_edge_count
    from rtvqa_tpu.ops.histogram import color_entropy, gray_entropy
    from rtvqa_tpu.kernels.motion_triton import block_match_field_triton
    from rtvqa_tpu.ops.motion import (
        block_match_field, block_match_motion_pyramid, down2_mean,
        fps_variation,
    )
    from rtvqa_tpu.ops.orb import orb_keypoint_count
    from rtvqa_tpu.ops.resize import resize_bilinear

    k = size.oracle_pairs
    r = tuple(p[:k] for p in ref)
    d = tuple(p[:k] for p in dis)

    # --- quality: the production chunk program on k frames -----------------
    packed, _ = _program_chunk(*r, *d, np.zeros((size.h, size.w), np.float32),
                               False)
    got = dict(zip(CHUNK_KEYS, np.asarray(packed)))
    jobs = [pool.submit(_quality_oracle, tuple(p[i] for p in r),
                        tuple(p[i] for p in d)) for i in range(k)]
    blur = np.stack(list(pool.map(_blur_oracle, list(r[0]))))
    want = [j.result() for j in jobs]
    for key, (kind, limit) in QUALITY_LIMITS.items():
        if key == "motion_sad":
            sad = np.abs(blur[1:] - blur[:-1]).mean(axis=(-2, -1))
            _compare(key, got[key][1:], sad, kind, limit)
            check(got[key][0] == 0.0, "motion_sad of the first frame is 0")
        else:
            _compare(key, got[key], [w_[key] for w_ in want], kind, limit)

    # --- complexity: each op of the suite on the card, fed the same
    # arrays as its oracle: the gray planes, their 64x64 resize and the
    # resized RGB planes of the k sampled (distorted) frames. The search,
    # Canny and FAST see integer-valued planes, as in their op tests: f32
    # sums of integers are exact, so SAD, gradient and corner-score ties
    # resolve as in float64.
    @jax.jit
    def intermediates(y, u, v):
        gray = yuv420_to_gray(y, u, v)
        rgb = jnp.stack(yuv420_to_rgb_planes(y, u, v), axis=-3)
        return gray, resize_bilinear(gray, 64, 64), resize_bilinear(rgb, 64, 64)

    @jax.jit
    def ops(gray, gray_rs, rgb_rs, ts):
        fps, _ = fps_variation(ts, jnp.ones(ts.shape, bool))
        gray_i, gray_rs_i = jnp.round(gray), jnp.round(gray_rs)
        return {
            "motion": block_match_motion_pyramid(gray_i[:-1], gray_i[1:]),
            "dct": dct_energy(gray_rs[1:]),
            "histogram": gray_entropy(gray_rs[1:]),
            "edge": canny_edge_count(gray_rs_i[1:]),
            "orb": orb_keypoint_count(gray_rs_i[1:]),
            "color": color_entropy(jnp.moveaxis(rgb_rs[1:], -3, -1)),
            "temporal_dct": temporal_dct_abs_diff(gray_rs[:-1], gray_rs[1:]),
            "framerate": fps,
        }

    gray, gray_rs, rgb_rs = (np.asarray(a) for a in intermediates(*d))
    ts_k = ts[:k].astype(np.float32)
    got = {key: np.asarray(val)
           for key, val in ops(gray, gray_rs, rgb_rs, ts_k).items()}
    jobs = [pool.submit(_complexity_oracle, gray[j - 1], gray[j],
                        gray_rs[j - 1], gray_rs[j], rgb_rs[j],
                        float(ts_k[j] - ts_k[j - 1])) for j in range(1, k)]
    want = [j.result() for j in jobs]
    for key, (kind, limit) in COMPLEXITY_LIMITS.items():
        _compare(f"complexity/{key}", got[key], [w_[key] for w_ in want],
                 kind, limit)

    # --- the motion search kernel against the XLA scan it replaces on the
    # GPU, on the pooled half-resolution frames (block 8, radius 4, as the
    # pyramid searches them). On integer-valued planes SAD sums are exact,
    # so the two fields must be bitwise equal. On the real planes each sums
    # in its own f32 order, so two candidates whose SADs tie within rounding
    # may resolve differently: there each block's chosen displacement must
    # have a float64 SAD within f32 summation error of the float64 minimum.
    half = np.asarray(jax.jit(down2_mean)(gray))
    scan = jax.jit(block_match_field, static_argnums=(2, 3))
    for name, planes in (("integer-valued", np.round(half)), ("real", half)):
        fields = {
            "kernel": block_match_field_triton(planes[:-1], planes[1:], 8, 4),
            "scan": scan(planes[:-1], planes[1:], 8, 4),
        }
        (k_dy, k_dx), (s_dy, s_dx) = ((np.asarray(dy), np.asarray(dx))
                                      for dy, dx in fields.values())
        agree = float(np.mean((k_dy == s_dy) & (k_dx == s_dx)))
        mag_k = np.hypot(k_dy, k_dx).mean((-2, -1))
        mag_s = np.hypot(s_dy, s_dx).mean((-2, -1))
        log(f"motion kernel vs scan ({name}): {agree:.6f} of blocks agree, "
            f"mean magnitudes {mag_k.tolist()} vs {mag_s.tolist()}")
        if name == "integer-valued":
            check(agree == 1.0, "motion kernel vs XLA scan, integer-valued "
                  "half-res fields bitwise equal")
            continue
        for who, (dy, dx) in fields.items():
            excess = max(_sad_excess(planes[j], planes[j + 1], np.asarray(dy[j]),
                                     np.asarray(dx[j]), 8, 4)
                         for j in range(planes.shape[0] - 1))
            check(excess <= MOTION_SAD_TIE_REL,
                  f"motion {who}, real half-res planes: chosen SAD exceeds the "
                  f"float64 minimum by {excess:.3g} rel <= {MOTION_SAD_TIE_REL:g}")


# ---------------------------------------------------------------------------
# Phase 5: the normal entry points
# ---------------------------------------------------------------------------


def check_rows(rows, fps: float, frame_interval: int, what: str) -> None:
    import math

    from rtvqa_tpu.metrics.complexity import METRIC_ORDER, ComplexityResult
    from rtvqa_tpu.pipeline.analyzer import complexity_columns

    columns = complexity_columns(ComplexityResult(*[0.0] * len(METRIC_ORDER)))
    check(len(rows) > 0, f"{what}: CSV has {len(rows)} row(s)")
    for row in rows:
        log(f"{what}: row {json.dumps(row)}")
        check(math.isfinite(float(row["PSNR"])) and math.isfinite(float(row["SSIM"])),
              f"{what}: PSNR {row['PSNR']} and SSIM {row['SSIM']} finite")
        check(all(row[c] != "" for c in columns),
              f"{what}: the eight complexity columns are filled")
        fv = float(row["Framerate Variation"])
        check(abs(fv - fps / frame_interval) <= 1e-3 * fps,
              f"{what}: Framerate Variation {fv} == fps/frame_interval")


def cli_phase(size: Size, clip, workdir: str, timer) -> None:
    """The CLI three times, decode included (native IO built)."""
    from fractions import Fraction

    from rtvqa_tpu import cli
    from rtvqa_tpu.io import video as vio
    from rtvqa_tpu.pipeline.csv_sink import read_rows

    y, u, v, _ = clip
    path = os.path.join(workdir, "clip.mp4")
    with timer.stage("encode seeded clip"):
        vio.encode_raw_yuv420(path, y, u, v, fps=Fraction(size.fps, 1), crf=18)
    runs = (("fi1", {"frame_interval": 1}, []),
            ("fi10", {}, []),
            ("sweep", {}, ["--sweep", "23", "33"]))
    for name, extra, args in runs:
        csv = os.path.join(workdir, f"{name}.csv")
        cfg = os.path.join(workdir, f"{name}.json")
        with open(cfg, "w") as f:
            json.dump({"csv_file": csv, "preset": "veryfast", **extra}, f)
        with timer.stage(f"cli {name}"):
            rc = cli.main([cfg, path, "--json", *args])
        check(rc == 0, f"cli {name} exit 0")
        check_rows(read_rows(csv), size.fps, extra.get("frame_interval", 10),
                   f"cli {name}")
        if args:
            manifest = [json.loads(line) for line in open(csv + ".manifest.jsonl")]
            failed = sum(rec["status"] == "failed" for rec in manifest)
            check(failed == 0 and len(manifest) == 2, f"sweep failed == {failed}")
        timer.add_frames(size.frames * (2 if args else 1))


def batches_phase(size: Size, clip, workdir: str, timer) -> None:
    """Without decode: the same three runs, fed as decoded-frame batches
    through ``analyze_combined_batches`` (the CLI's chunk loop)."""
    from rtvqa_tpu.config import Config
    from rtvqa_tpu.metrics.full_reference import analyze_combined_batches
    from rtvqa_tpu.pipeline.analyzer import complexity_columns, quality_columns
    from rtvqa_tpu.pipeline.csv_sink import read_rows, update_csv

    y, u, v, ts = clip
    runs = (("fi1", 1, (23,)), ("fi10", 10, (23,)), ("sweep", 10, (23, 33)))
    for name, fi, crfs in runs:
        cfg = Config(frame_interval=fi, csv_file=os.path.join(workdir, f"{name}.csv"))
        for crf in crfs:  # no decode, so no bad clip: any error ends the smoke
            dis = distort((y, u, v), crf, seed=crf)
            with timer.stage(f"batches {name} crf {crf}"):
                qual, comp = analyze_combined_batches(
                    frame_batches((y, u, v), ts, size.chunk),
                    frame_batches(dis, ts, size.chunk),
                    chunk=size.chunk, frame_interval=cfg.frame_interval,
                    resize_width=cfg.resize_width,
                    resize_height=cfg.resize_height,
                    smoothing_factor=cfg.smoothing_alpha,
                    complexity_chunk=cfg.batch_size,
                    motion_search=cfg.motion_search,
                )
            timer.add_frames(qual["n_frames"])
            update_csv({
                "Resolution (px)": f"{size.w}x{size.h}",
                "Frame Rate (fps)": float(size.fps), "CRF": crf,
                **quality_columns(qual, cfg), **complexity_columns(comp),
            }, csv_file=cfg.csv_file)
        rows = read_rows(cfg.csv_file)
        check(len(rows) == len(crfs), f"batches {name}: one row per CRF")
        check_rows(rows, size.fps, fi, f"batches {name}")


# ---------------------------------------------------------------------------
# --four: the sharded sweep on four GPUs
# ---------------------------------------------------------------------------


def sweep_sharded_batches(size: Size, clip, crfs, devices) -> dict:
    """The device work of ``run_sweep_sharded`` from decoded frames: frame-
    sharded quality per item, then one batched sharded complexity program
    over all items. Returns {crf: (quality dict, ComplexityResult)}."""
    import numpy as np

    from rtvqa_tpu.io.video import DecodedClip
    from rtvqa_tpu.parallel.sharding import make_mesh
    from rtvqa_tpu.pipeline.batch_analyzer import complexity_sharded_clips
    from rtvqa_tpu.pipeline.quality_sharded import (
        full_reference_sharded_batches, sharded_chunk,
    )

    y, u, v, ts = clip
    n_dev = len(devices)
    qmesh = make_mesh(n_clip=1, n_frame=n_dev, devices=devices)
    n_clip = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    cmesh = make_mesh(n_clip=n_clip, n_frame=n_dev // n_clip, devices=devices)
    chunk = sharded_chunk(qmesh, size.w, size.h)
    quals, clips = {}, []
    for crf in crfs:
        dis = distort((y, u, v), crf, seed=crf)
        quals[crf] = full_reference_sharded_batches(
            frame_batches((y, u, v), ts, chunk), frame_batches(dis, ts, chunk),
            chunk=chunk, mesh=qmesh,
        )
        keep = np.arange(9, size.frames, 10)  # frame_interval 10, 1-based
        clips.append(DecodedClip(
            y=dis[0][keep], u=dis[1][keep], v=dis[2][keep],
            timestamps_ms=ts[keep], width=size.w, height=size.h,
            n_frames_total=size.frames, bit_rate=0, avg_fps=float(size.fps),
        ))
    comps = complexity_sharded_clips(clips, 64, 64, 0.8, mesh=cmesh)
    return {crf: (quals[crf], comp) for crf, comp in zip(crfs, comps)}


def sweep_sharded_cli(size: Size, path: str, crfs, n_dev: int, workdir: str):
    """``run_sweep_sharded`` itself over an encoded clip, on ``n_dev``
    devices; returns {crf: CSV row}."""
    import dataclasses

    from rtvqa_tpu.config import Config
    from rtvqa_tpu.pipeline.csv_sink import read_rows
    from rtvqa_tpu.pipeline.sweep import run_sweep_sharded

    cfg = dataclasses.replace(
        Config(), csv_file=os.path.join(workdir, f"sweep{n_dev}.csv"),
        preset="veryfast", data_parallel_devices=n_dev,
    )
    stats = run_sweep_sharded([path], cfg, crf_ladder=crfs)
    check(stats["failed"] == 0, f"sweep on {n_dev} device(s): {stats}")
    rows = read_rows(cfg.csv_file)
    check_rows(rows, size.fps, cfg.frame_interval, f"sweep on {n_dev} device(s)")
    return {int(r["CRF"]): r for r in rows}


def four_phase(size: Size, clip, devices, workdir: str) -> None:
    import numpy as np

    from rtvqa_tpu.metrics.complexity import METRIC_ORDER, ComplexityResult
    from rtvqa_tpu.pipeline.analyzer import complexity_columns

    crfs = (18, 23, 28, 33)
    decode = native_io_available()
    t0 = time.perf_counter()
    if decode:
        from fractions import Fraction

        from rtvqa_tpu.io import video as vio

        path = os.path.join(workdir, "clip.mp4")
        vio.encode_raw_yuv420(path, *clip[:3], fps=Fraction(size.fps, 1), crf=18)
        t0 = time.perf_counter()
        sharded = sweep_sharded_cli(size, path, crfs, len(devices), workdir)
    else:
        sharded = sweep_sharded_batches(size, clip, crfs, devices)
    t1 = time.perf_counter()
    if decode:
        single = sweep_sharded_cli(size, path, crfs, 1, workdir)
    else:
        single = sweep_sharded_batches(size, clip, crfs, devices[:1])
    t2 = time.perf_counter()
    log(f"sweep on {len(devices)} devices {t1 - t0:.1f}s, on 1 device "
        f"{t2 - t1:.1f}s (compilation included)")
    columns = list(complexity_columns(ComplexityResult(*[0.0] * len(METRIC_ORDER))))
    for crf in crfs:
        if decode:
            ra, rb = sharded[crf], single[crf]
            qa = {"psnr": float(ra["PSNR"]), "ssim": float(ra["SSIM"])}
            qb = {"psnr": float(rb["PSNR"]), "ssim": float(rb["SSIM"])}
            ca = np.array([float(ra[c]) for c in columns])
            cb = np.array([float(rb[c]) for c in columns])
        else:
            (qa, comp_a), (qb, comp_b) = sharded[crf], single[crf]
            ca, cb = np.array(comp_a.as_tuple()), np.array(comp_b.as_tuple())
            for key in ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3",
                        "adm2", "motion2"):
                _compare(f"four/crf{crf}/{key}", qa["per_frame"][key],
                         qb["per_frame"][key], "rel", 2e-4)
        log(f"crf {crf}: psnr {qa['psnr']:.6f} vs {qb['psnr']:.6f}, ssim "
            f"{qa['ssim']:.8f} vs {qb['ssim']:.8f}")
        _compare(f"four/crf{crf}/psnr", qa["psnr"], qb["psnr"], "abs", 1e-4)
        _compare(f"four/crf{crf}/ssim", qa["ssim"], qb["ssim"], "abs", 1e-6)
        _compare(f"four/crf{crf}/complexity", ca, cb, "rel", 1e-4)


# ---------------------------------------------------------------------------


def run(size: Size, four: bool = False, card: str = "") -> dict:
    """Every phase after the pytest run, in this process."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    import jax

    from rtvqa_tpu.obs.jaxcache import enable_persistent_cache
    from rtvqa_tpu.obs.profiler import StageTimer

    devices = jax.devices()
    dev = devices[0]
    log(f"JAX devices: {len(devices)} x {dev.platform} {dev.device_kind}")
    log(f"compile cache: {enable_persistent_cache()}")
    timer = StageTimer()
    with timer.stage("make seeded clip"):
        clip = make_clip(size)
    if four:
        if len(devices) != 4:
            raise SmokeFailure(f"--four needs 4 devices, JAX has {len(devices)}")
        with tempfile.TemporaryDirectory(prefix="rtvqa_smoke_") as workdir:
            four_phase(size, clip, devices, workdir)
    else:
        with timer.stage("compile"):
            compile_programs(size)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=8, mp_context=ctx) as pool:
            with timer.stage("oracles"):
                oracle_phase(size, clip[:3], distort(clip[:3], 23, seed=23),
                             clip[3], pool)
        with tempfile.TemporaryDirectory(prefix="rtvqa_smoke_") as workdir:
            if native_io_available():
                cli_phase(size, clip, workdir, timer)
            else:
                batches_phase(size, clip, workdir, timer)
    log(f"StageTimer on {card}: {json.dumps(timer.summary())}")
    stats = dev.memory_stats() or {}
    log(f"peak_bytes_in_use on {card}: {stats.get('peak_bytes_in_use')}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded sweep on four GPUs")
    args = parser.parse_args(argv)
    try:
        card = require_gpu_machine()
        print(card, flush=True)
        card = " / ".join(dict.fromkeys(card.splitlines()))  # one label
        if not args.four:
            run_gpu_tests()
        sys.path.insert(0, REPO)
        import jax

        if jax.devices()[0].platform != "gpu":
            raise SmokeFailure(
                f"JAX's first device is {jax.devices()[0].platform!r}, not a GPU")
        device = run(FULL, four=args.four, card=card)
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
