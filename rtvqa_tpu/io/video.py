"""Python bindings for the native host-IO runtime (ctypes over librtvqa_io).

One decode pass returns sampled YUV420 frame batches + per-frame timestamps,
replacing the reference's three separate ``cv2.VideoCapture`` passes
(``complexity_metrics.py:76-111``, ``:506-541``, ``:38-73``; SURVEY.md §2.4(3))
and its ``ffprobe``/``ffmpeg`` subprocesses (``video_processing.py:101-142``,
``:200-214``). Color-space conversion is deliberately NOT done here — frames
ship to the device as planar YUV (1.5 bytes/px, half the host-to-device
bytes of RGB) and the RGB/gray conversions run on the device (`rtvqa_tpu.ops.color`).

The shared library is built from ``native/rtvqa_io.cpp`` at first use (or
by ``make -C native``); nothing prebuilt is shipped. Importing this module
always succeeds; calling an IO function where the library cannot be built
raises ``NativeIOUnavailable`` with the compiler's message (so pure-compute
tests never need the toolchain).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import tempfile
from fractions import Fraction
from typing import Optional

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(__file__), "_lib")
_LIB_PATH = os.path.join(_LIB_DIR, "librtvqa_io.so")


class NativeIOUnavailable(RuntimeError):
    pass


class ClipError(RuntimeError):
    """A clip that cannot be opened, probed, decoded or encoded."""


# What the pipelines treat as a bad clip: an empty quality cell, or one
# failed sweep item. Every other error (a device program that fails to lower,
# compile or run, a missing native library) propagates.
BAD_CLIP_ERRORS = (ClipError, FileNotFoundError)


_lib: Optional[ctypes.CDLL] = None


def _build_lib() -> None:
    """Build the native library in-tree (g++ + the FFmpeg development libs).

    The compiler writes a temporary file that is renamed into place, so
    processes that build at the same time (parallel test workers) never see
    a half-written library. A failed build raises ``NativeIOUnavailable``
    carrying the compiler's stderr.
    """
    src = os.path.join(os.path.dirname(__file__), "..", "..", "native", "rtvqa_io.cpp")
    src = os.path.abspath(src)
    if not os.path.isfile(src):
        raise NativeIOUnavailable(f"native IO source not found at {src}")
    os.makedirs(_LIB_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o", tmp, src,
        "-lavformat", "-lavcodec", "-lavutil", "-lswscale",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise NativeIOUnavailable(f"native IO build failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeIOUnavailable(
            f"native IO build failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp, _LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.isfile(_LIB_PATH):
        _build_lib()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.rtvqa_last_error.restype = ctypes.c_char_p
    lib.rtvqa_decode_open.restype = ctypes.c_void_p
    lib.rtvqa_decode_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rtvqa_decode_open_threads.restype = ctypes.c_void_p
    lib.rtvqa_decode_open_threads.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.rtvqa_decode_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.rtvqa_decode_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rtvqa_decode_close.argtypes = [ctypes.c_void_p]
    lib.rtvqa_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.rtvqa_transcode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
    ]
    lib.rtvqa_encode_raw.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
    ]
    _lib = lib
    return lib


def _err(lib) -> str:
    return lib.rtvqa_last_error().decode(errors="replace")


VALID_VIDEO_EXT = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def validate_video_path(input_path: str) -> str:
    """Extension gate, mirroring the reference (``complexity_metrics.py:25-35``)
    with a slightly wider container whitelist."""
    if not isinstance(input_path, str):
        raise ValueError("Invalid input path. Please provide a valid file path.")
    lower = input_path.lower()
    if lower.endswith(VALID_VIDEO_EXT):
        return "video"
    if lower.endswith((".jpg", ".png")):
        return "frame"
    raise ValueError("Unsupported file type. Please provide a video or frame file.")


@dataclasses.dataclass
class DecodedClip:
    """Sampled frames of one clip as planar YUV420 batches.

    ``y``: (N, H, W) uint8; ``u``/``v``: (N, H/2, W/2) uint8;
    ``timestamps_ms``: (N,) float64 presentation timestamps of the *sampled*
    frames; consecutive sampled frames are ``frame_interval`` source frames
    apart — exactly the pairing semantics of the reference's
    ``read_frame_pairs`` (``complexity_metrics.py:76-111``).
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    timestamps_ms: np.ndarray
    width: int
    height: int
    n_frames_total: int
    bit_rate: int
    avg_fps: float


def decode_sampled(
    path: str, frame_interval: int = 10, threads: Optional[int] = None
) -> DecodedClip:
    """Decode ``path`` once, keeping every ``frame_interval``-th frame (1-based).

    ``threads`` bounds the decoder's thread count (the honoured analog of the
    reference's ignored ``num_workers`` config — SURVEY.md §2.4(8));
    None/0 = codec auto.
    """
    validate_video_path(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    lib = _load()
    handle = lib.rtvqa_decode_open_threads(
        path.encode(), int(frame_interval), int(threads or 0)
    )
    if not handle:
        raise ClipError(f"decode failed: {_err(lib)}")
    try:
        info = (ctypes.c_int64 * 8)()
        lib.rtvqa_decode_info(handle, info)
        n, w, h, cw, ch, total, bitrate, fps_milli = (int(x) for x in info)
        y = np.empty((n, h, w), dtype=np.uint8)
        u = np.empty((n, ch, cw), dtype=np.uint8)
        v = np.empty((n, ch, cw), dtype=np.uint8)
        ts = np.empty((n,), dtype=np.float64)
        if n > 0:
            lib.rtvqa_decode_copy(
                handle,
                y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        return DecodedClip(
            y=y, u=u, v=v, timestamps_ms=ts, width=w, height=h,
            n_frames_total=total, bit_rate=bitrate, avg_fps=fps_milli / 1000.0,
        )
    finally:
        lib.rtvqa_decode_close(handle)


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    bitrate_kbps: int
    resolution: str
    frame_rate: float
    width: int
    height: int


def get_video_info(path: str) -> VideoInfo:
    """Stream probe, replacing the ffprobe subprocess + ``eval()`` hazard
    (``video_processing.py:101-142``, SURVEY.md §2.4(7)). The fps fraction is
    evaluated as an exact rational."""
    lib = _load()
    info = (ctypes.c_int64 * 6)()
    if lib.rtvqa_probe(path.encode(), info) < 0:
        raise ClipError(f"probe failed: {_err(lib)}")
    w, h, bitrate_bps, fps_num, fps_den, _ = (int(x) for x in info)
    fps = float(Fraction(fps_num, fps_den)) if fps_den > 0 and fps_num >= 0 else 0.0
    return VideoInfo(
        bitrate_kbps=bitrate_bps // 1000,
        resolution=f"{w}x{h}",
        frame_rate=fps,
        width=w,
        height=h,
    )


def transcode(in_path: str, out_path: str, crf: int = 23, preset: str = "medium") -> None:
    """In-process libx264 transcode, replacing the encode subprocess
    (``video_processing.py:200-214``)."""
    lib = _load()
    rc = lib.rtvqa_transcode(in_path.encode(), out_path.encode(), int(crf), preset.encode())
    if rc < 0:
        raise ClipError(f"transcode failed: {_err(lib)}")


def encode_raw_yuv420(
    out_path: str,
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    fps: Fraction = Fraction(30, 1),
    crf: int = 23,
    preset: str = "medium",
) -> None:
    """Encode raw planar YUV420 frames to an H.264 mp4 (test-clip synthesis)."""
    lib = _load()
    n, h, w = y.shape
    y = np.ascontiguousarray(y, dtype=np.uint8)
    u = np.ascontiguousarray(u, dtype=np.uint8)
    v = np.ascontiguousarray(v, dtype=np.uint8)
    rc = lib.rtvqa_encode_raw(
        out_path.encode(),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, w, h, fps.numerator, fps.denominator, int(crf), preset.encode(),
    )
    if rc < 0:
        raise ClipError(f"encode failed: {_err(lib)}")


def encode_raw_rgb(
    out_path: str,
    rgb: np.ndarray,
    fps: Fraction = Fraction(30, 1),
    crf: int = 23,
    preset: str = "medium",
) -> None:
    """Encode (N, H, W, 3) uint8 RGB frames via BT.601 limited-range YUV420."""
    from rtvqa_tpu.ops.color import rgb_to_yuv420_np

    yuv = rgb_to_yuv420_np(rgb)
    encode_raw_yuv420(out_path, *yuv, fps=fps, crf=crf, preset=preset)
