"""VMAF model loading + SVR prediction.

Loads the official libvmaf model format — a JSON file whose ``model_dict``
carries feature names, linear-rescale normalization (slopes/intercepts),
score clip/transform, and a libsvm nu-SVR model blob (RBF kernel) — e.g.
``vmaf_v0.6.1.json`` as shipped with libvmaf. This is the ``model_path``
config key the reference forwards to the libvmaf filter
(``video_processing.py:279-280``).

Prediction follows libsvm/libvmaf semantics per frame:

1. normalize each feature: ``x' = slope[i+1] * x + intercept[i+1]``
   (index 0 of slopes/intercepts denormalizes the score);
2. RBF nu-SVR: ``y' = sum_j coef_j * exp(-gamma * ||x' - sv_j||^2) - rho``;
3. denormalize ``y = (y' - intercept[0]) / slope[0]``;
4. optional polynomial score transform, then clip to ``score_clip``.

The SVR evaluation is a JAX kernel: the support-vector matrix becomes a
(n_sv, n_feat) constant and the per-frame evaluation is one distance matmul —
batched over all frames at once, pinned to ``HIGHEST`` precision.

If no model file is available (this build environment has none — zero
egress, SURVEY.md §6), ``builtin_model()`` provides a transparent linear
fallback over the same six features. It is clearly labeled: it preserves
VMAF's qualitative behavior (identity → ~100, monotone in each feature) but
is NOT score-parity with libvmaf; drop an official model JSON next to the
config for parity.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Canonical feature order of the default VMAF v0.6.1 model.
DEFAULT_FEATURES = (
    "VMAF_feature_adm2_score",
    "VMAF_feature_motion2_score",
    "VMAF_feature_vif_scale0_score",
    "VMAF_feature_vif_scale1_score",
    "VMAF_feature_vif_scale2_score",
    "VMAF_feature_vif_scale3_score",
)

# Short keys produced by our extractors -> model feature names.
FEATURE_KEY_MAP = {
    "adm2": "VMAF_feature_adm2_score",
    "motion2": "VMAF_feature_motion2_score",
    "vif_scale0": "VMAF_feature_vif_scale0_score",
    "vif_scale1": "VMAF_feature_vif_scale1_score",
    "vif_scale2": "VMAF_feature_vif_scale2_score",
    "vif_scale3": "VMAF_feature_vif_scale3_score",
}


@dataclasses.dataclass(frozen=True)
class VmafModel:
    feature_names: tuple[str, ...]
    slopes: np.ndarray          # (n_feat + 1,) — [0] rescales the score
    intercepts: np.ndarray      # (n_feat + 1,)
    kind: str                   # 'rbf_nusvr' | 'linear'
    # rbf_nusvr:
    gamma: float = 0.0
    rho: float = 0.0
    sv: Optional[np.ndarray] = None       # (n_sv, n_feat)
    sv_coef: Optional[np.ndarray] = None  # (n_sv,)
    # linear:
    weights: Optional[np.ndarray] = None  # (n_feat,)
    bias: float = 0.0
    score_clip: Optional[tuple[float, float]] = (0.0, 100.0)
    score_transform: Optional[tuple[float, ...]] = None  # polynomial coeffs (p0, p1, p2, ...)
    name: str = "unnamed"
    # Per-feature extractor options (libvmaf ``feature_opts_dicts``, merged):
    # NEG-mode models carry {'vif_enhn_gain_limit': x, 'adm_enhn_gain_limit': y}
    # here; the full-reference engine threads them into the extractors.
    feature_opts: tuple[tuple[str, float], ...] = ()

    @property
    def vif_enhn_gain_limit(self) -> Optional[float]:
        return dict(self.feature_opts).get("vif_enhn_gain_limit")

    @property
    def adm_enhn_gain_limit(self) -> Optional[float]:
        return dict(self.feature_opts).get("adm_enhn_gain_limit")

    def predict(self, features: dict[str, jnp.ndarray]) -> jnp.ndarray:
        """Per-frame scores from per-frame feature arrays (each (N,))."""
        cols = []
        for fname in self.feature_names:
            short = next((k for k, v in FEATURE_KEY_MAP.items() if v == fname), fname)
            if fname in features:
                cols.append(jnp.asarray(features[fname], jnp.float32))
            elif short in features:
                cols.append(jnp.asarray(features[short], jnp.float32))
            else:
                raise KeyError(f"model needs feature {fname!r}; have {sorted(features)}")
        x = jnp.stack(cols, axis=-1)  # (N, n_feat)

        slopes = jnp.asarray(self.slopes, jnp.float32)
        intercepts = jnp.asarray(self.intercepts, jnp.float32)
        xn = x * slopes[1:] + intercepts[1:]

        if self.kind == "rbf_nusvr":
            sv = jnp.asarray(self.sv, jnp.float32)            # (S, F)
            coef = jnp.asarray(self.sv_coef, jnp.float32)     # (S,)
            # ||x - s||^2 = |x|^2 + |s|^2 - 2 x.s — one matmul.
            x2 = jnp.sum(xn * xn, axis=-1, keepdims=True)     # (N, 1)
            s2 = jnp.sum(sv * sv, axis=-1)[None, :]           # (1, S)
            cross = jnp.einsum(
                "nf,sf->ns", xn, sv,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            dist_sq = jnp.maximum(x2 + s2 - 2.0 * cross, 0.0)
            k = jnp.exp(-self.gamma * dist_sq)                # (N, S)
            y = jnp.dot(k, coef, precision=jax.lax.Precision.HIGHEST) - self.rho
        elif self.kind == "linear":
            w = jnp.asarray(self.weights, jnp.float32)
            y = jnp.dot(xn, w, precision=jax.lax.Precision.HIGHEST) + self.bias
        else:
            raise ValueError(self.kind)

        score = (y - intercepts[0]) / slopes[0]
        if self.score_transform is not None:
            p = self.score_transform
            t = jnp.zeros_like(score)
            for i, c in enumerate(p):
                t = t + c * score**i
            score = t
        if self.score_clip is not None:
            score = jnp.clip(score, self.score_clip[0], self.score_clip[1])
        return score


def _parse_libsvm_text(text: str) -> dict:
    """Parse a libsvm nu-SVR model dump (the ``model`` blob in vmaf JSON)."""
    lines = text.strip().splitlines()
    header: dict = {}
    sv_lines: list[str] = []
    in_sv = False
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if in_sv:
            sv_lines.append(line)
            continue
        if line == "SV":
            in_sv = True
            continue
        parts = line.split()
        header[parts[0]] = parts[1:]
    coefs, vecs = [], []
    n_feat = 0
    for line in sv_lines:
        parts = line.split()
        coefs.append(float(parts[0]))
        pairs = [p.split(":") for p in parts[1:]]
        if pairs:
            n_feat = max(n_feat, max(int(i) for i, _ in pairs))
        vecs.append({int(i): float(v) for i, v in pairs})
    sv = np.zeros((len(vecs), n_feat), np.float64)
    for r, d in enumerate(vecs):
        for i, val in d.items():
            sv[r, i - 1] = val
    return {
        "gamma": float(header.get("gamma", ["0"])[0]),
        "rho": float(header.get("rho", ["0"])[0]),
        "sv_coef": np.asarray(coefs, np.float64),
        "sv": sv,
        "kernel": header.get("kernel_type", ["rbf"])[0],
        "svm_type": header.get("svm_type", ["nu_svr"])[0],
    }


def load_model(path: str) -> VmafModel:
    """Load a libvmaf-format model JSON (v2 ``model_dict`` layout)."""
    with open(path) as f:
        raw = json.load(f)
    md = raw.get("model_dict", raw)
    feature_names = tuple(md["feature_names"])
    slopes = np.asarray(md["slopes"], np.float64)
    intercepts = np.asarray(md["intercepts"], np.float64)
    clip = tuple(md["score_clip"]) if md.get("score_clip") else None
    transform = None
    st = md.get("score_transform")
    if st:
        coeffs = []
        i = 0
        while f"p{i}" in st:
            coeffs.append(float(st[f"p{i}"]))
            i += 1
        transform = tuple(coeffs) if coeffs else None

    # NEG variants (e.g. vmaf_v0.6.1neg.json) carry per-feature extractor
    # options in ``feature_opts_dicts`` — a list parallel to feature_names.
    opts: dict[str, float] = {}
    for d in md.get("feature_opts_dicts") or []:
        if isinstance(d, dict):
            for k, v in d.items():
                opts[str(k)] = float(v)

    model_blob = md.get("model")
    if isinstance(model_blob, str):
        svm = _parse_libsvm_text(model_blob)
        if svm["kernel"] != "rbf":
            raise ValueError(f"unsupported SVM kernel {svm['kernel']!r}")
        return VmafModel(
            feature_names=feature_names,
            slopes=slopes,
            intercepts=intercepts,
            kind="rbf_nusvr",
            gamma=svm["gamma"],
            rho=svm["rho"],
            sv=svm["sv"],
            sv_coef=svm["sv_coef"],
            score_clip=clip,
            score_transform=transform,
            name=str(raw.get("version", path)),
            feature_opts=tuple(sorted(opts.items())),
        )
    raise ValueError(f"unrecognized model format in {path}")


def builtin_model() -> VmafModel:
    """Transparent linear fallback (NOT libvmaf score-parity; see module doc).

    Feature ranges are normalized to ~[0,1] (adm2, vif_* already are; motion2
    is scaled by 1/20 and capped by the clip), then combined with weights that
    reflect each feature's influence in published VMAF sensitivity analyses.
    An all-identity input (adm2=1, vif=1, motion2=m) maps to ~100.
    """
    n = len(DEFAULT_FEATURES)
    slopes = np.ones(n + 1, np.float64)
    intercepts = np.zeros(n + 1, np.float64)
    slopes[0] = 0.01  # score denormalization: y/0.01 -> 0..100
    # feature order: adm2, motion2, vif0..3
    slopes[2] = 1.0 / 20.0  # motion2 normalization
    weights = np.asarray([0.45, -0.02, 0.10, 0.12, 0.15, 0.22], np.float64)
    # bias chosen so that perfect features with motion2=0 give exactly 100.
    bias = 1.0 - float(weights[0] + weights[2:].sum())
    return VmafModel(
        feature_names=DEFAULT_FEATURES,
        slopes=slopes,
        intercepts=intercepts,
        kind="linear",
        weights=weights,
        bias=bias,
        score_clip=(0.0, 100.0),
        name="rtvqa-builtin-linear-v1 (NOT libvmaf parity)",
    )
