"""Headline benchmark: 1080p frames/sec/GPU, full metric suite.

Measures the on-device programs (eight-metric complexity suite + PSNR/SSIM +
VMAF features VIF/ADM) over synthetic 1080p YUV420 frame batches on one GPU,
against a vectorized NumPy CPU implementation of the same hot kernels (proxy
for the reference's OpenCV/ffmpeg CPU path — the reference itself cannot run
here: no cv2/ffmpeg binaries, SURVEY.md §6).

The parent process never imports JAX: one child process (``--phase all``)
owns the GPU and runs both device phases, while the parent runs the CPU
baseline. The child refuses to run unless JAX's first device is a GPU, and
a phase that fails makes the whole bench fail with no number. Every JSON
line names the platform, ``device_kind``, the device count, and the card's
name and power limit as ``nvidia-smi`` reports them.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

H, W = 1080, 1920
N_DEVICE = 128   # frames per batch
REPS = 2
N_CPU = 2        # frames for the CPU baseline (extrapolated)
METRIC = "1080p_full_suite_frames_per_sec_per_gpu"


def card_info() -> dict:
    """The card's name and power limit from ``nvidia-smi`` (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(","))
    return {"card": name, "power_limit": limit}


def device_info() -> dict:
    """JAX's view of the device; raises unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's first device is {dev.platform!r}"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def make_frames(n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2) % 256
    y = np.stack([(base + 7 * i) % 256 for i in range(n)]).astype(np.uint8)
    y = np.clip(
        y.astype(np.int16) + rng.integers(0, 8, y.shape, dtype=np.int16), 0, 255
    ).astype(np.uint8)
    u = rng.integers(100, 156, (n, h // 2, w // 2), np.uint8)
    v = rng.integers(100, 156, (n, h // 2, w // 2), np.uint8)
    return y, u, v


def device_frame_fns(n, h, w):
    """Jitted on-device synthetic frame generators shared by every device
    phase (1080p headline, 1440p and 4K phases): same gradient+noise
    recipe as ``make_frames`` so all measurements see content-equivalent
    inputs. Returns (gen(seed) -> (y, u, v), distort(y, seed) -> dy)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(seed):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        fi = jax.lax.broadcasted_iota(jnp.int32, (n, h, w), 0)
        yy = jax.lax.broadcasted_iota(jnp.int32, (n, h, w), 1)
        xx = jax.lax.broadcasted_iota(jnp.int32, (n, h, w), 2)
        base = (xx * 3 + yy * 2 + 7 * fi) % 256
        noise = jax.random.randint(k1, (n, h, w), 0, 8, jnp.int32)
        y = jnp.clip(base + noise, 0, 255).astype(jnp.uint8)
        u = jax.random.randint(
            k2, (n, h // 2, w // 2), 100, 156, jnp.int32
        ).astype(jnp.uint8)
        v = jax.random.randint(
            k3, (n, h // 2, w // 2), 100, 156, jnp.int32
        ).astype(jnp.uint8)
        return y, u, v

    @jax.jit
    def distort(y, seed):
        noise = jax.random.randint(
            jax.random.PRNGKey(seed), y.shape, -4, 5, dtype=jnp.int16
        )
        return jnp.clip(y.astype(jnp.int16) + noise, 0, 255).astype(jnp.uint8)

    return gen, distort


# ---------------------------------------------------------------------------
# Child: both device phases in one process
# ---------------------------------------------------------------------------


def _time_reps(dispatch, reps: int = REPS) -> float:
    """Mean seconds per call of ``dispatch()`` over ``reps`` calls, each
    result materialized on the host inside the timed region. Depth-1
    pipelined, as in the production chunk loop: call k's fetch waits until
    call k+1 is dispatched."""
    t0 = time.perf_counter()
    prev = None
    for _ in range(reps):
        out = dispatch()
        if prev is not None:
            np.asarray(prev)
        prev = out
    np.asarray(prev)
    return (time.perf_counter() - t0) / reps


def phase_all() -> int:
    """Run complexity + quality phases on the GPU; print one DEVICE line and
    PHASE_SECONDS lines as each phase completes."""
    from rtvqa_tpu.metrics.complexity import complexity_suite_packed
    from rtvqa_tpu.metrics.full_reference import _program_chunk
    from rtvqa_tpu.obs.jaxcache import enable_persistent_cache

    print("DEVICE " + json.dumps(device_info()), flush=True)
    enable_persistent_cache()
    t_start = time.perf_counter()

    def note(msg):
        print(f"[bench] {msg} (+{time.perf_counter() - t_start:.1f}s)", flush=True)

    # All inputs synthesized on the device: the measured programs are
    # content-independent in cost (static shapes, exact-SAD search, no
    # data-dependent control flow).
    gen_ref, make_dis = device_frame_fns(N_DEVICE, H, W)
    ry, ru, rv = gen_ref(0)
    dy = make_dis(ry, 1)
    np.asarray(dy[0, 0, :8])
    note("inputs staged (whole batch synthesized on the device)")

    # --- complexity phase --------------------------------------------------
    n = np.int32(N_DEVICE)
    ts = (np.arange(N_DEVICE) * 33.3).astype(np.float32)

    def disp_c():
        return complexity_suite_packed(ry, ru, rv, ts, n, resize_h=64, resize_w=64)

    np.asarray(disp_c())  # warmup/compile
    note("complexity compiled + warm")
    print(f"PHASE_SECONDS complexity {_time_reps(disp_c)}", flush=True)

    # --- quality phase -----------------------------------------------------
    blur = np.zeros((H, W), np.float32)

    def disp_q():
        return _program_chunk(ry, ru, rv, dy, ru, rv, blur, True)[0]

    np.asarray(disp_q())  # warmup/compile
    note("quality compiled + warm")
    print(f"PHASE_SECONDS quality {_time_reps(disp_q)}", flush=True)
    note("all phases done")
    return 0


def phase_4k() -> int:
    return phase_res(2160, 3840, "4k")


def phase_1440p() -> int:
    return phase_res(1440, 2560, "1440p")


def phase_res(h4: int, w4: int, label: str) -> int:
    """Wide-resolution device-program throughput, measured like the headline:
    quality chunks at the production auto_chunk (16 at 4K, 36 at 1440p),
    complexity batched to the same pixel count as 128x1080p. Prints one
    JSON line with seconds per frame of each phase."""
    from rtvqa_tpu.metrics.complexity import complexity_suite_packed
    from rtvqa_tpu.metrics.full_reference import _program_chunk, auto_chunk
    from rtvqa_tpu.obs.jaxcache import enable_persistent_cache

    device = device_info()
    enable_persistent_cache()
    nq = auto_chunk(w4, h4)
    nc = max(2, int(128 * (1080 * 1920) / (h4 * w4)) // 2 * 2)
    gen, distort = device_frame_fns(nc, h4, w4)
    y, u, v = gen(0)
    dy = distort(y[:nq], 1)
    yq, uq, vq = y[:nq], u[:nq], v[:nq]
    ts = (np.arange(nc) * 33.3).astype(np.float32)
    n_valid = np.int32(nc)

    def disp_c():
        return complexity_suite_packed(
            y, u, v, ts, n_valid, resize_h=64, resize_w=64
        )

    np.asarray(disp_c())
    comp_spf = _time_reps(disp_c) / nc
    blur = np.zeros((h4, w4), np.float32)

    def disp_q():
        return _program_chunk(yq, uq, vq, dy, uq, vq, blur, True)[0]

    np.asarray(disp_q())
    qual_spf = _time_reps(disp_q) / nq
    fps = 1.0 / (comp_spf + qual_spf)
    print(json.dumps({
        "metric": f"{label}_full_suite_frames_per_sec_per_gpu",
        "value": fps, "unit": "frames/sec/gpu",
        "quality_seconds_per_frame": qual_spf,
        "complexity_seconds_per_frame": comp_spf,
        "device": device, **card_info(),
    }))
    return 0


# ---------------------------------------------------------------------------
# CPU baseline proxy
# ---------------------------------------------------------------------------


def cpu_baseline_secs() -> float:
    """Seconds per frame for a vectorized NumPy equivalent of the hot path.

    NOTE: this proxy covers the dominant kernels
    (block-match motion, DCT, histogram, Sobel, MSE/SSIM-style windows, one
    Gaussian moment pass) but is LIGHTER than the full reference pipeline (no
    ORB/Canny/color entropy/4-scale VIF/ADM) — so ``vs_baseline`` is a
    conservative-in-our-disfavor label of CPU-proxy speedup, not a measured
    reference-pipeline ratio. The JSON line carries this caveat.
    """
    import scipy.fft
    import scipy.ndimage as ndi

    ry, _, _ = make_frames(N_CPU, seed=0)
    dy = np.clip(
        ry.astype(np.int16)
        + np.random.default_rng(1).integers(-4, 5, ry.shape, dtype=np.int16),
        0, 255,
    ).astype(np.uint8)
    t0 = time.perf_counter()
    for i in range(N_CPU):
        ref = ry[i].astype(np.float32)
        dis = dy[i].astype(np.float32)
        small = ref[:1024, :1792].reshape(64, 16, 64, 28).mean((1, 3))
        d = scipy.fft.dct(scipy.fft.dct(small, axis=0, norm="ortho"), axis=1, norm="ortho")
        _ = (d * d).sum()
        hist, _ = np.histogram(ref, bins=256, range=(0, 256))
        p = hist / hist.sum()
        _ = -(p[p > 0] * np.log2(p[p > 0])).sum()
        gx = ndi.sobel(small, 1)
        gy = ndi.sobel(small, 0)
        _ = ((np.abs(gx) + np.abs(gy)) > 200).sum()
        prev = ry[i - 1].astype(np.float32) if i else ref
        best = None
        refc = ref[:1072]
        for dyy in range(-4, 5):
            for dxx in range(-4, 5):
                shifted = np.roll(np.roll(prev, dyy, 0), dxx, 1)[:1072]
                sad = np.abs(refc - shifted).reshape(67, 16, 120, 16).sum((1, 3))
                best = sad if best is None else np.minimum(best, sad)
        diff = ref - dis
        _ = (diff * diff).mean()
        mu_r = ndi.uniform_filter(ref, 8)
        mu_d = ndi.uniform_filter(dis, 8)
        _ = ndi.uniform_filter(ref * dis, 8) - mu_r * mu_d
        g = ndi.gaussian_filter(ref, 17 / 5.0)
        _ = ndi.gaussian_filter(ref * ref, 17 / 5.0) - g * g
    return (time.perf_counter() - t0) / N_CPU


# ---------------------------------------------------------------------------
# End-to-end (decode-included) phase, opt-in via --e2e
# ---------------------------------------------------------------------------


def make_video_frames(n, variant=0, h=H, w=W):
    """Camera-plausible 1080p content: smooth structured luma with global
    motion and a few moving objects — NOT per-pixel noise. Dense noise makes
    x264 emit ~100 Mbps bitstreams whose 1-core decode crawls at ~2 fps and
    says nothing about real footage (CRF-18 1080p is typically 5-15 Mbps)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w), np.uint8)
    for i in range(n):
        t = i + 31.0 * variant
        img = (
            120.0
            + 55.0 * np.sin(2 * np.pi * (xx + 2.5 * t) / 240.0)
            + 35.0 * np.cos(2 * np.pi * (yy + 1.5 * t) / 180.0)
        )
        bx = int(300 + 6 * t) % (w - 200)
        by = int(200 + 4 * t) % (h - 200)
        img[by : by + 160, bx : bx + 160] = 230.0
        img[(h - by - 160) : (h - by), (w - bx - 160) : (w - bx)] = 25.0
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    u = np.full((n, h // 2, w // 2), 120, np.uint8)
    v = np.full((n, h // 2, w // 2), 132, np.uint8)
    return frames, u, v


def _e2e_clips(dirname: str, variant: int, n: int = 128) -> tuple[str, str]:
    """Write a real 1080p H.264 clip pair into ``dirname`` for the
    end-to-end benchmark: ref encoded from synthetic YUV, dis = CRF-28
    re-encode. Distinct content per variant."""
    from fractions import Fraction

    from rtvqa_tpu.io import video as vio

    ref = os.path.join(dirname, f"ref_{variant}.mp4")
    dis = os.path.join(dirname, f"dis_{variant}.mp4")
    y, u, v = make_video_frames(n, variant)
    vio.encode_raw_yuv420(ref, y, u, v, fps=Fraction(30, 1), crf=18, preset="veryfast")
    vio.transcode(ref, dis, crf=28, preset="veryfast")
    return ref, dis


def phase_e2e() -> int:
    """Seconds per frame, END-TO-END: native decode of both streams + full
    quality suite (every frame) + complexity suite (frame_interval=10)
    through the combined single-decode-pass engine."""
    from rtvqa_tpu.io.stream import VideoStream
    from rtvqa_tpu.metrics.full_reference import analyze_combined
    from rtvqa_tpu.obs.jaxcache import enable_persistent_cache

    print("DEVICE " + json.dumps(device_info()), flush=True)
    enable_persistent_cache()
    with tempfile.TemporaryDirectory(prefix="rtvqa_bench_") as d:
        clips = [_e2e_clips(d, variant) for variant in range(REPS + 1)]

        def run(ref, dis):
            t0 = time.perf_counter()
            qual, _comp = analyze_combined(
                ref, dis, frame_interval=10, resize_width=64, resize_height=64
            )
            return time.perf_counter() - t0, int(qual["n_frames"])

        run(*clips[0])  # warmup/compile on variant 0
        total_dt, total_n = 0.0, 0
        for ref, dis in clips[1:]:
            dt, n = run(ref, dis)
            total_dt += dt
            total_n += n
        t0 = time.perf_counter()
        for path in clips[1]:
            for _ in VideoStream(path, 1, 64):
                pass
        decode_dt = time.perf_counter() - t0
    print(
        f"[bench] e2e: {total_n} frames in {total_dt:.2f}s "
        f"({total_n / total_dt:.1f} f/s); decode-only floor for one rep: "
        f"{decode_dt:.2f}s ({(total_n / REPS) / decode_dt:.1f} f/s)",
        flush=True,
    )
    print(f"PHASE_SECONDS e2e {total_dt / total_n}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# Parent driver (stays off JAX)
# ---------------------------------------------------------------------------


def _run_child(phase: str, phases: dict) -> dict:
    """Run ``bench.py --phase <phase>`` in a child process, collecting its
    PHASE_SECONDS lines into ``phases``; return its DEVICE record. A child
    that fails makes the bench fail."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase", phase],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    err_buf: list[str] = []
    t_err = threading.Thread(target=lambda: err_buf.extend(proc.stderr),
                             daemon=True)
    t_err.start()
    device = None
    for line in proc.stdout:
        line = line.strip()
        if line.startswith("[bench] "):
            sys.stderr.write(line + "\n")
            sys.stderr.flush()
        elif line.startswith("PHASE_SECONDS "):
            _, name, secs = line.split()
            phases[name] = float(secs)
        elif line.startswith("DEVICE "):
            device = json.loads(line[len("DEVICE "):])
    proc.wait()
    t_err.join()
    if proc.returncode != 0 or device is None:
        raise SystemExit(
            f"bench child --phase {phase} failed (rc={proc.returncode}):\n"
            + "".join(err_buf)[-4000:]
        )
    return device


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--phase", choices=["all", "e2e", "4k", "1440p"], default=None,
        help="Run one device phase in this process (the parent runs 'all').",
    )
    parser.add_argument(
        "--e2e", action="store_true",
        help="Report the decode-included end-to-end fps instead of the "
        "device-program headline.",
    )
    args = parser.parse_args()

    if args.phase == "all":
        return phase_all()
    if args.phase == "e2e":
        return phase_e2e()
    if args.phase == "4k":
        return phase_4k()
    if args.phase == "1440p":
        return phase_1440p()

    card = card_info()
    phases: dict[str, float] = {}
    if args.e2e:
        device = _run_child("e2e", phases)
        spf = phases["e2e"]
        print(json.dumps({
            "metric": "1080p_e2e_decode_included_frames_per_sec_per_gpu",
            "value": 1.0 / spf,
            "unit": "frames/sec/gpu",
            "vs_baseline": (1.0 / spf) / (1.0 / cpu_baseline_secs()),
            "device": device, **card,
        }))
        return 0

    # Headline: the device child runs while the parent times the CPU proxy.
    result: dict = {}

    def child():
        try:
            result["device"] = _run_child("all", phases)
        except SystemExit as e:
            result["error"] = e

    t = threading.Thread(target=child)
    t.start()
    cpu_spf = cpu_baseline_secs()
    t.join()
    if "error" in result:
        raise result["error"]

    from rtvqa_tpu.obs.roofline import (
        attach_measured, complexity_roofline, quality_roofline,
    )

    device = result["device"]
    total_dt = phases["complexity"] + phases["quality"]  # serialized, as in production
    device_fps = N_DEVICE / total_dt
    print(json.dumps({
        "metric": METRIC,
        "value": device_fps,
        "unit": "frames/sec/gpu",
        "vs_baseline": device_fps / (1.0 / cpu_spf),
        # The CPU baseline is a vectorized-NumPy proxy of the hot kernels,
        # lighter than the full reference pipeline.
        "vs_baseline_definition": "device fps / vectorized NumPy hot-kernel proxy fps (proxy omits ORB/Canny/color-entropy/VIF-ADM; ratio is an upper bound on proxy cost, lower bound on reference cost)",
        "device": device, **card,
        "roofline": {
            "quality_1080p": attach_measured(
                quality_roofline(1080, 1920), phases["quality"] / N_DEVICE,
                device["kind"]),
            "complexity_1080p": attach_measured(
                complexity_roofline(1080, 1920),
                phases["complexity"] / N_DEVICE, device["kind"]),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
