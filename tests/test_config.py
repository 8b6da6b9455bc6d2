import json

import pytest

from rtvqa_tpu.config import Config, ConfigError, load_config


def write_cfg(tmp_path, raw):
    p = tmp_path / "config.json"
    p.write_text(json.dumps(raw))
    return str(p)


REFERENCE_DEFAULTS = {
    "crf": 23,
    "vmaf_model_path": None,
    "resize_width": 64,
    "resize_height": 64,
    "frame_interval": 10,
}


def test_reference_config_loads(tmp_path):
    # The reference's shipped config.json must load unchanged.
    cfg = load_config(write_cfg(tmp_path, REFERENCE_DEFAULTS))
    assert cfg.crf == 23
    assert cfg.resize_width == 64
    assert cfg.frame_interval == 10
    assert cfg.smoothing_alpha == 0.8  # reference hard-codes this


@pytest.mark.parametrize(
    "patch",
    [
        {"crf": 0},
        {"crf": 52},
        {"resize_width": 0},
        {"resize_height": -1},
        {"frame_interval": 0},
        {"num_workers": "four"},
        {"batch_size": 0},
        {"smoothing_alpha": 0.0},
        {"smoothing_alpha": 1.5},
        {"quality_backend": "ffmpeg_subprocess"},
        {"preset": "medum"},
        {"preset": ""},
        {"streaming_complexity": "yes"},
        {"streaming_complexity": 1},
        {"quality_precision": "bf16"},
        {"quality_precision": True},
        {"motion_search": "farneback"},
        {"motion_search": 2},
    ],
)
def test_invalid_configs_rejected(tmp_path, patch):
    raw = dict(REFERENCE_DEFAULTS)
    raw.update(patch)
    with pytest.raises(ConfigError):
        load_config(write_cfg(tmp_path, raw))


def test_valid_preset_and_streaming_flags(tmp_path):
    raw = dict(
        REFERENCE_DEFAULTS, preset="veryfast", streaming_complexity=True,
        motion_search="full",
    )
    cfg = load_config(write_cfg(tmp_path, raw))
    assert cfg.preset == "veryfast"
    assert cfg.streaming_complexity is True
    assert cfg.motion_search == "full"


def test_quality_precision_values(tmp_path, caplog):
    """Every accepted value still loads (existing configs keep working);
    only "fast" warns, since all metrics are computed in exact f32."""
    import logging

    for v in ("auto", "exact", "fast", None):
        raw = dict(REFERENCE_DEFAULTS, quality_precision=v)
        with caplog.at_level(logging.WARNING, logger="rtvqa_tpu.config"):
            caplog.clear()
            cfg = load_config(write_cfg(tmp_path, raw))
        assert cfg.quality_precision == v
        warned = [r for r in caplog.records if "no effect" in r.getMessage()]
        assert len(warned) == (1 if v == "fast" else 0), v


def test_unknown_key_rejected(tmp_path):
    raw = dict(REFERENCE_DEFAULTS, tpyo=1)
    with pytest.raises(ConfigError):
        load_config(write_cfg(tmp_path, raw))


def test_missing_file():
    with pytest.raises(ConfigError):
        load_config("/nonexistent/config.json")


def test_bad_json(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    with pytest.raises(ConfigError):
        load_config(str(p))
