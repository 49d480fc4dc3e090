"""The port's stage timers and traces (``flac_raster_tpu_torch.utils.profiling``)
against the JAX package's ``StageTimer`` on the same stages, and the
converter's named stages."""

import json
import logging

import numpy as np
import pytest
import torch

from flac_raster_tpu.utils.profiling import StageTimer as JaxStageTimer
from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch.utils import profiling
from flac_raster_tpu_torch.utils.profiling import StageTimer, device_trace, timed_stage


def _stages(timer):
    with timer.stage("normalize", nbytes=4_000_000):
        pass
    with timer.stage("encode"):
        pass
    return timer


def test_stage_records_and_report(caplog):
    timer = _stages(StageTimer(enabled=True))
    jax_timer = _stages(JaxStageTimer(enabled=True))
    assert [r.name for r in timer.records] == [r.name for r in jax_timer.records]
    assert [r.bytes for r in timer.records] == [4_000_000, 0]
    assert timer.as_dict().keys() == jax_timer.as_dict().keys() == {"normalize", "encode"}
    assert timer.total_seconds() == sum(r.seconds for r in timer.records) >= 0
    assert timer.records[0].mb_per_s == 4.0 / timer.records[0].seconds
    with caplog.at_level(logging.INFO, logger="flac_raster_tpu_torch.profiling"):
        timer.report()
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2
    assert lines[0].startswith("normalize ") and lines[0].endswith(" MB/s")
    assert lines[1].startswith("encode ") and lines[1].endswith("s")


def test_disabled_timer_records_nothing(caplog):
    with caplog.at_level(logging.DEBUG, logger="flac_raster_tpu_torch.profiling"):
        timer = _stages(StageTimer())
        timer.report()
    assert timer.records == [] and timer.as_dict() == {} and timer.total_seconds() == 0
    assert caplog.records == []


def test_a_stage_that_raises_is_recorded():
    timer = StageTimer(enabled=True)
    with pytest.raises(ValueError), timer.stage("fails"):
        raise ValueError("inside the stage")
    assert [r.name for r in timer.records] == ["fails"]


def test_timed_stage_logs_at_debug(caplog):
    with caplog.at_level(logging.DEBUG, logger="flac_raster_tpu_torch.profiling"):
        with timed_stage("write", nbytes=1_000_000):
            pass
    (rec,) = caplog.records
    assert rec.levelno == logging.DEBUG and rec.getMessage().startswith("write: ")


def _trace_names(trace_dir) -> set:
    (path,) = trace_dir.glob("frtt.*.pt.trace.json")
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_device_trace_holds_the_chunk_loop_and_the_stages(tmp_path, caplog):
    data = np.arange(64 * 256, dtype=np.uint16).reshape(1, 64, 256) * 3
    conv = RasterFLACConverter(device="cpu")
    with caplog.at_level(logging.DEBUG, logger="flac_raster_tpu_torch"):
        with device_trace(tmp_path / "trace", "cpu"):
            blob = conv.encode_array(data, compression_level=5)
    names = _trace_names(tmp_path / "trace")
    assert {"frtt.plan_and_emit", "frtt.stage.encode", "frtt.stage.stats"} <= names
    # the converter's report, one line per stage
    report = [r.getMessage() for r in caplog.records if r.name.endswith("profiling")]
    assert any(m.startswith("encode ") for m in report)
    back, _ = conv.decode_bytes(blob)
    assert np.array_equal(back, data)


def test_device_trace_without_a_directory_does_nothing(tmp_path):
    with device_trace(None):
        pass
    with device_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []


def test_device_trace_on_cuda_without_cupti_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot record CUDA activity"):
        with device_trace(tmp_path / "t", "cuda"):
            pass
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("dtype,lossless,stage", [
    (np.uint16, True, "stats"),
    (np.float32, True, "normalize_lossless"),
    (np.uint16, False, "normalize_minmax"),
])
def test_converter_names_its_normalization_stage(dtype, lossless, stage, caplog):
    data = (np.arange(4096 + 100) % 700).astype(dtype).reshape(1, 1, -1)
    conv = RasterFLACConverter(lossless=lossless, device="cpu")
    with caplog.at_level(logging.DEBUG, logger="flac_raster_tpu_torch"):
        conv.encode_array(data, compression_level=0)
    names = {r.getMessage().split(":")[0] for r in caplog.records
             if r.name == profiling.logger.name}
    assert {stage, "encode"} <= names


def test_tile_batch_names_its_stages_and_ranges(tmp_path, caplog):
    tiles = (np.arange(3 * 64 * 64) % 500).astype(np.uint16).reshape(3, 1, 64, 64)
    conv = RasterFLACConverter(device="cpu")
    with caplog.at_level(logging.DEBUG, logger="flac_raster_tpu_torch"):
        with device_trace(tmp_path, "cpu"):
            conv.encode_array_batch(tiles, compression_level=1)
    names = _trace_names(tmp_path)
    assert {"frtt.stage.tiles_stats", "frtt.stage.tiles_encode", "frtt.tile_md5",
            "frtt.tile_header"} <= names


def test_disabled_converter_timer_opens_no_stage_range(tmp_path):
    conv = RasterFLACConverter(device="cpu")
    logging.getLogger("flac_raster_tpu_torch.converter").setLevel(logging.INFO)
    try:
        with device_trace(tmp_path, "cpu"):
            conv.encode_array(np.zeros((1, 8, 600), np.uint16), compression_level=0)
    finally:
        logging.getLogger("flac_raster_tpu_torch.converter").setLevel(logging.NOTSET)
    names = _trace_names(tmp_path)
    assert "frtt.plan_and_emit" in names
    assert not any(n and n.startswith("frtt.stage.") for n in names)
