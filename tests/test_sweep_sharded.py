"""Integrated multi-chip batched sweep (BASELINE configs[4]) vs the
sequential driver: row-for-row CSV equality on 8 virtual devices."""

import dataclasses
import json
from fractions import Fraction

import numpy as np
import pytest

from rtvqa_tpu.config import Config
from rtvqa_tpu.io import video as vio
from rtvqa_tpu.pipeline.csv_sink import CSV_COLUMNS, read_rows
from rtvqa_tpu.pipeline.sweep import run_sweep, run_sweep_sharded


def make_clip(path, n=24, h=64, w=64, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        base = ((xx * 3 + yy * 2 + i * 7) % 256).astype(np.uint8)
        f = np.stack([base, np.roll(base, i % 5, 1), 255 - base], -1)
        f = np.clip(f.astype(np.int16) + rng.integers(0, 10, f.shape), 0, 255)
        frames.append(f.astype(np.uint8))
    vio.encode_raw_rgb(path, np.stack(frames), fps=Fraction(30, 1), crf=20)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_sharded")
    paths = []
    for i in range(2):
        p = str(d / f"clip{i}.mp4")
        make_clip(p, seed=5 + i)
        paths.append(p)
    return {"dir": str(d), "clips": paths}


def _base_config(tmp_path, name):
    return Config.from_dict(
        {
            "crf": 28,
            "resize_width": 64,
            "resize_height": 64,
            "frame_interval": 3,
            "csv_file": str(tmp_path / f"{name}.csv"),
        }
    )


def test_sharded_sweep_matches_sequential(corpus, tmp_path):
    ladder = [30, 40]
    cfg_seq = _base_config(tmp_path, "seq")
    cfg_sh = _base_config(tmp_path, "sharded")

    stats_seq = run_sweep(
        corpus["clips"], cfg_seq, crf_ladder=ladder,
        manifest_path=str(tmp_path / "seq.jsonl"),
    )
    stats_sh = run_sweep_sharded(
        corpus["clips"], cfg_sh, crf_ladder=ladder,
        manifest_path=str(tmp_path / "sh.jsonl"),
    )
    assert stats_seq == {"done": 4, "failed": 0, "skipped": 0}
    assert stats_sh == {"done": 4, "failed": 0, "skipped": 0}

    rows_seq = read_rows(cfg_seq.csv_file)
    rows_sh = read_rows(cfg_sh.csv_file)
    assert len(rows_seq) == len(rows_sh) == 4
    for rs, rh in zip(rows_seq, rows_sh):
        for col in CSV_COLUMNS:
            a, b = rs[col], rh[col]
            if col in ("Resolution (px)", "CRF"):
                assert a == b, col
            elif a == "" or b == "":
                assert a == b, col
            else:
                np.testing.assert_allclose(
                    float(a), float(b), rtol=2e-3, atol=1e-5, err_msg=col
                )


def test_sharded_sweep_resume_and_isolation(corpus, tmp_path):
    cfg = _base_config(tmp_path, "resume")
    manifest = str(tmp_path / "m.jsonl")

    stats = run_sweep_sharded(
        corpus["clips"][:1], cfg, crf_ladder=[35], manifest_path=manifest
    )
    assert stats == {"done": 1, "failed": 0, "skipped": 0}

    # Resume: done item skipped, CSV untouched.
    stats2 = run_sweep_sharded(
        corpus["clips"][:1], cfg, crf_ladder=[35], manifest_path=manifest
    )
    assert stats2 == {"done": 0, "failed": 0, "skipped": 1}
    assert len(read_rows(cfg.csv_file)) == 1

    # A missing clip fails in isolation; the good one still lands.
    stats3 = run_sweep_sharded(
        [corpus["clips"][1], corpus["dir"] + "/nope.mp4"],
        cfg, crf_ladder=[35], manifest_path=manifest,
    )
    assert stats3["done"] == 1 and stats3["failed"] == 1
    assert len(read_rows(cfg.csv_file)) == 2


@pytest.mark.parametrize("driver", [run_sweep, run_sweep_sharded],
                         ids=["sequential", "sharded"])
def test_device_program_failure_stops_the_sweep(corpus, tmp_path, monkeypatch,
                                                driver):
    """A device program that fails to build is not a bad clip: the motion
    search raising what a Pallas lowering rule raises (an AssertionError)
    propagates out of the sweep instead of turning items into 'failed'."""
    import jax

    from rtvqa_tpu.ops import motion

    def fails_to_lower(*args, **kwargs):
        raise AssertionError("lowering failed")

    monkeypatch.setattr(motion, "block_match_field", fails_to_lower)
    jax.clear_caches()  # no program traced earlier may skip the search
    manifest = tmp_path / "broken.jsonl"
    with pytest.raises(AssertionError, match="lowering failed"):
        driver(corpus["clips"][:1], _base_config(tmp_path, "broken"),
               crf_ladder=[35], manifest_path=str(manifest))
    assert not manifest.exists() or "failed" not in manifest.read_text()


def test_data_parallel_devices_bounds_mesh(corpus, tmp_path, monkeypatch):
    """The config key actually selects the mesh size (SURVEY §2.4(8) redux)."""
    import rtvqa_tpu.parallel.sharding as sharding

    sizes = []
    real_make_mesh = sharding.make_mesh

    def spy(n_clip=1, n_frame=None, devices=None):
        mesh = real_make_mesh(n_clip=n_clip, n_frame=n_frame, devices=devices)
        sizes.append(mesh.devices.size)
        return mesh

    monkeypatch.setattr(sharding, "make_mesh", spy)
    cfg = dataclasses.replace(
        _base_config(tmp_path, "dpd"), data_parallel_devices=2
    )
    stats = run_sweep_sharded(
        corpus["clips"][:1], cfg, crf_ladder=[35],
        manifest_path=str(tmp_path / "dpd.jsonl"),
    )
    assert stats["done"] == 1
    assert sizes and all(s == 2 for s in sizes)


def test_builtin_vmaf_fallback_not_in_csv_by_default(corpus, tmp_path):
    """Artifact-level fallback signal: no model file => empty VMAF cell,
    unless allow_builtin_vmaf opts in."""
    cfg = _base_config(tmp_path, "fallback")
    run_sweep_sharded(
        corpus["clips"][:1], cfg, crf_ladder=[35],
        manifest_path=str(tmp_path / "f1.jsonl"),
    )
    row = read_rows(cfg.csv_file)[0]
    assert row["VMAF"] == ""
    assert row["PSNR"] != ""

    cfg2 = dataclasses.replace(
        _base_config(tmp_path, "fallback2"), allow_builtin_vmaf=True
    )
    run_sweep_sharded(
        corpus["clips"][:1], cfg2, crf_ladder=[35],
        manifest_path=str(tmp_path / "f2.jsonl"),
    )
    row2 = read_rows(cfg2.csv_file)[0]
    assert row2["VMAF"] != ""
    assert 0.0 <= float(row2["VMAF"]) <= 100.0
