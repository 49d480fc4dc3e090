"""The benchmark's files by name, its contract's shape, and what it imports."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_loads_by_name(w):
    cell = spec.cell(BENCH, w["name"])
    assert cell.chips == 1
    assert spec.op_module(cell.traffic["op"]).Op
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/configs/")
    config = json.loads((spec.ROOT / c["file"]).read_text())
    assert config["name"] == c["name"] and config["reduced"] == c["reduced"] == []
    assert {"generator", "height", "width", "dtype", "crs", "transform", "level", "md5",
            "normalization", "bits_per_sample", "blocksize"} <= set(config["raster"])


def test_names_units_and_metric_links():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_new_metric_is_a_new_file(tmp_path):
    """A per-layer metric added by a file and an entry, nothing edited."""
    shutil.copytree(spec.BENCH / "metrics", tmp_path / "metrics")
    (tmp_path / "metrics" / "enc.requests_traced.py").write_text(
        "def read(run):\n    return float(len(run.window.requests))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "enc.requests_traced", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "encode_MBps", "workloads": ["s2_l2a_band.encode"]})
    cell = spec.cell(bench, "s2_l2a_band.encode")
    assert "enc.requests_traced" in [m["name"] for m in cell.per_layer]
    read = spec.metric_reader("enc.requests_traced", tmp_path / "metrics")

    class Window:
        requests = [1, 2, 3]

    class Run:
        window = Window()

    assert read(Run()) == 3.0


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(spec.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(spec.BENCH)))
def test_no_jax_and_a_clean_reference(path):
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "flac_raster_tpu"}, names
    if path.parent.name == "reference":
        assert "flac_raster_tpu_torch" not in names, names
