"""VMAF end-to-end: feature extraction (VIF + ADM + motion) + SVR pooling.

Replaces the ``libvmaf`` filter of the reference's metrics subprocess
(``video_processing.py:280-282``). Per-frame features feed the model's
per-frame prediction; the clip score is the mean of per-frame scores —
libvmaf's ``pooled_metrics.vmaf.mean``, the value the reference scrapes from
the JSON log (``video_processing.py:171-173``).

Feature extraction is chunked over frames (static chunk shape, one compiled
executable), with motion2 computed over the full luma sequence (it needs
t-1/t/t+1 context, so SADs are computed per-chunk with one overlap frame).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from rtvqa_tpu.obs.logging import get_logger
from rtvqa_tpu.vmaf.adm import adm_features
from rtvqa_tpu.vmaf.model import VmafModel, builtin_model, load_model
from rtvqa_tpu.vmaf.motion import motion_features
from rtvqa_tpu.vmaf.vif import vif_features

logger = get_logger("rtvqa_tpu.vmaf")

import functools

import jax


@functools.partial(jax.jit)
def _frame_features(ref_y: jnp.ndarray, dis_y: jnp.ndarray) -> dict[str, jnp.ndarray]:
    """Spatial (per-frame) features for a chunk: VIF scales + adm2."""
    out = vif_features(ref_y, dis_y)
    out.update(adm_features(ref_y, dis_y))
    return out


def extract_features(
    ref_clip, dis_clip, chunk: Optional[int] = None
) -> dict[str, np.ndarray]:
    """Per-frame VMAF features for two decoded clips (luma planes).

    The default chunk (4 frames at 1080p) scales with resolution.
    """
    n = min(ref_clip.y.shape[0], dis_clip.y.shape[0])
    h, w = ref_clip.y.shape[1:]
    if chunk is None:
        chunk = max(1, min(64, int(4 * (1080 * 1920) / max(h * w, 1))))
    feats: dict[str, list[np.ndarray]] = {}
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        pad = chunk - (end - start)

        def prep(a):
            a = a[start:end].astype(np.float32)
            if pad:
                a = np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)
            return a

        out = _frame_features(prep(ref_clip.y), prep(dis_clip.y))
        for k, val in out.items():
            feats.setdefault(k, []).append(np.asarray(val)[: end - start])

    result = {k: np.concatenate(v) for k, v in feats.items()}
    # Motion runs over the whole reference luma sequence at once (cheap blur
    # + SAD; full-sequence context for the min() in motion2).
    m = motion_features(jnp.asarray(ref_clip.y[:n], jnp.float32))
    result["motion"] = np.asarray(m["motion"])
    result["motion2"] = np.asarray(m["motion2"])
    return result


def compute_vmaf(
    ref_clip,
    dis_clip,
    model_path: Optional[str] = None,
    return_details: bool = False,
):
    """Clip-level VMAF score (mean of per-frame model predictions)."""
    if model_path:
        model = load_model(model_path)
    else:
        model = builtin_model()
        logger.warning(
            "No VMAF model file given; using %s — scores are qualitative, "
            "not libvmaf-parity. Provide vmaf_v0.6.1.json via vmaf_model_path.",
            model.name,
        )
    feats = extract_features(ref_clip, dis_clip)
    per_frame = np.asarray(model.predict(feats))
    score = float(per_frame.mean()) if per_frame.size else 0.0
    if return_details:
        return score, {"per_frame": per_frame, "features": feats, "model": model.name}
    return score
