"""The port's command line (``flac_raster_tpu_torch.cli``) on the CPU.

The twelve cases of ``tests/test_cli.py`` run through the port's ``main``
with ``--device cpu``; then the two command lines side by side on the same
200 x 260 int16 GeoTIFF: ``convert`` at levels 0 and 2 writes the JAX CLI's
bytes, each CLI decodes the other's level-5 file exactly, and ``info`` and
``query`` print the same lines (``query -o`` the same JSON).  Without a card
every command on the default ``--device cuda`` exits 1.
"""

import json
from unittest.mock import MagicMock, patch

import numpy as np
import pytest

from flac_raster_tpu.cli import main as jax_main
from flac_raster_tpu_torch.cli import main as port_main
from flac_raster_tpu_torch.io.geo import Affine
from flac_raster_tpu_torch.io.geotiff import open_geotiff, write_geotiff

CPU = ["--device", "cpu"]


def main(argv):
    return port_main([*argv, *CPU])


@pytest.fixture
def tif(tmp_path, rng):
    data = rng.integers(0, 2000, (1, 200, 260)).astype(np.int16)
    p = tmp_path / "in.tif"
    write_geotiff(p, data, crs="EPSG:4326",
                  transform=Affine.from_origin(-105.5, 40.5, 0.001, 0.001))
    return p, data


def test_convert_roundtrip(tmp_path, tif):
    p, data = tif
    flac = tmp_path / "out.flac"
    assert main(["convert", str(p), "-o", str(flac)]) == 0
    back = tmp_path / "back.tif"
    assert main(["convert", str(flac), "-o", str(back)]) == 0
    assert np.array_equal(open_geotiff(back).read(), data)


def test_force_guard(tmp_path, tif):
    p, _ = tif
    flac = tmp_path / "out.flac"
    assert main(["convert", str(p), "-o", str(flac), "-c", "0"]) == 0
    assert main(["convert", str(p), "-o", str(flac), "-c", "0"]) == 1  # exists, no --force
    assert main(["convert", str(p), "-o", str(flac), "-c", "0", "--force"]) == 0


def test_unsupported_format(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"nope")
    assert main(["convert", str(bad)]) == 1


def test_missing_input():
    assert main(["convert", "/nonexistent/file.tif"]) == 1


def test_info(tmp_path, tif, capsys):
    p, _ = tif
    flac = tmp_path / "out.flac"
    main(["convert", str(p), "-o", str(flac), "-c", "0"])
    assert main(["info", str(flac)]) == 0
    out = capsys.readouterr().out
    assert "260 x 200" in out and "EPSG:4326" in out
    assert main(["info", str(p)]) == 0


def test_streaming_and_extract(tmp_path, tif):
    p, data = tif
    s = tmp_path / "s.flac"
    assert main(["convert", str(p), "--streaming", "-t", "128", "-c", "1", "-o", str(s)]) == 0
    out_tif = tmp_path / "tile.tif"
    assert main(["extract", str(s), "-o", str(out_tif), "--tile-id", "1"]) == 0
    assert np.array_equal(open_geotiff(out_tif).read(), data[:, 0:128, 128:256])
    # center and last selection modes
    assert main(["extract", str(s), "-o", str(tmp_path / "c.tif"), "--center"]) == 0
    assert main(["extract", str(s), "-o", str(tmp_path / "l.tif"), "--last"]) == 0
    assert np.array_equal(open_geotiff(tmp_path / "l.tif").read(), data[:, 128:200, 256:260])
    # bbox with negative coords (argparse normalization)
    assert main(["extract", str(s), "-o", str(tmp_path / "b.tif"),
                 "-b", "-105.49,40.49,-105.48,40.5"]) == 0
    # no selector -> error
    assert main(["extract", str(s), "-o", str(tmp_path / "x.tif")]) == 1
    # unknown tile id -> error
    assert main(["extract", str(s), "-o", str(tmp_path / "x.tif"), "--tile-id", "99"]) == 1


def test_query_and_export(tmp_path, tif):
    p, _ = tif
    sp = tmp_path / "sp.flac"
    assert main(["convert", str(p), "--spatial", "-t", "128", "-c", "1", "-o", str(sp)]) == 0
    out_json = tmp_path / "ranges.json"
    assert main(["query", str(sp), "-b", "-105.49,40.49,-105.48,40.5",
                 "-o", str(out_json)]) == 0
    ranges = json.loads(out_json.read_text())
    assert ranges["total_bytes"] > 0 and len(ranges["ranges"]) >= 1


def test_compare_command(tmp_path, tif):
    p, _ = tif
    flac = tmp_path / "f.flac"
    back = tmp_path / "b.tif"
    main(["convert", str(p), "-o", str(flac), "-c", "0"])
    main(["convert", str(flac), "-o", str(back)])
    export = tmp_path / "cmp.json"
    assert main(["compare", str(p), str(back), "-e", str(export)]) == 0
    assert json.loads(export.read_text())["arrays_equal"] is True
    assert main(["compare", str(p), "/nonexistent.tif"]) == 1


def test_minmax_flag(tmp_path, tif):
    p, data = tif
    flac = tmp_path / "mm.flac"
    assert main(["convert", str(p), "--minmax", "-c", "0", "-o", str(flac)]) == 0
    back = tmp_path / "mmback.tif"
    assert main(["convert", str(flac), "-o", str(back)]) == 0
    assert np.array_equal(open_geotiff(back).read(), data)


def test_extract_rows_plain_flac(tmp_path, tif):
    """--rows extracts a row window of a plain whole-raster FLAC through the
    FRTP decode index."""
    p, data = tif
    flac = tmp_path / "whole.flac"
    assert main(["convert", str(p), "-o", str(flac), "-c", "0"]) == 0
    out = tmp_path / "win.tif"
    assert main(["extract", str(flac), "-o", str(out), "--rows", "50:40"]) == 0
    with open_geotiff(out) as src:
        assert np.array_equal(src.read(), data[:, 50:90])
        # origin shifted down by 50 pixels
        assert abs(src.transform.f - (40.5 - 0.001 * 50)) < 1e-9
    assert main(["extract", str(flac), "-o", str(out), "--rows", "bad"]) == 1
    assert main(["extract", str(flac), "-o", str(out), "--rows", "190:40"]) == 1


def _range_session(blob, seen_ranges):
    """requests.Session stand-in replaying ``blob`` for ranged GETs."""
    session = MagicMock()

    def fake_get(url, headers=None, timeout=None):
        a, b = map(int, headers["Range"].split("=")[1].split("-"))
        seen_ranges.append((a, b))
        m = MagicMock()
        m.status_code = 206
        m.content = blob[a : b + 1]
        m.headers = {"Content-Range": f"bytes {a}-{b}/{len(blob)}"}
        return m

    def fake_head(url, timeout=None):
        m = MagicMock()
        m.headers = {"content-length": str(len(blob)), "accept-ranges": "bytes"}
        m.raise_for_status = lambda: None
        return m

    session.get.side_effect = fake_get
    session.head.side_effect = fake_head
    return session


def test_extract_rows_remote_ranged(tmp_path, rng, monkeypatch, capsys):
    """Remote --rows is ranged: a header prefix and the covering frame span,
    two GETs, at most 20% of the file."""
    from flac_raster_tpu_torch.converter import RasterFLACConverter

    data = np.cumsum(rng.integers(-60, 61, (1, 600, 520)), axis=2).astype(np.int16)
    p = tmp_path / "big.tif"
    write_geotiff(p, data, crs="EPSG:4326",
                  transform=Affine.from_origin(-105.5, 40.5, 0.001, 0.001))
    flac = tmp_path / "whole.flac"
    assert main(["convert", str(p), "-o", str(flac), "-c", "0"]) == 0
    blob = flac.read_bytes()
    monkeypatch.setattr(RasterFLACConverter, "_HEADER_PREFETCH", 8192)

    seen: list = []
    out = tmp_path / "rwin.tif"
    with patch("flac_raster_tpu_torch.io.remote.create_session",
               return_value=_range_session(blob, seen)):
        assert main(["extract", "https://example.com/whole.flac",
                     "-o", str(out), "--rows", "120:40"]) == 0
    assert np.array_equal(open_geotiff(out).read(), data[:, 120:160])
    assert len(seen) == 2, seen
    assert seen[0][0] == 0 and seen[0][1] == 8191, seen
    fetched = sum(min(b, len(blob) - 1) - a + 1 for a, b in seen)
    assert fetched <= 0.2 * len(blob), (fetched, len(blob), seen)
    assert "Fetched" in capsys.readouterr().out


def test_decode_rows_ranged_fallback_without_index(tmp_path, tif, monkeypatch):
    """A remote stream without the FRTP index is fetched whole and decoded
    by decode_rows, still returning the right window."""
    from flac_raster_tpu_torch.converter import RasterFLACConverter
    from flac_raster_tpu_torch.io.remote import RemoteFile

    p, data = tif
    flac = tmp_path / "whole.flac"
    assert main(["convert", str(p), "-o", str(flac), "-c", "0"]) == 0
    blob = flac.read_bytes().replace(b"FRTP", b"XXXX", 1)  # kill the index
    monkeypatch.setattr(RasterFLACConverter, "_HEADER_PREFETCH", 8192)

    with patch("flac_raster_tpu_torch.io.remote.create_session",
               return_value=_range_session(blob, [])):
        rf = RemoteFile("https://example.com/noindex.flac")
        win, meta, fetched = RasterFLACConverter(device="cpu").decode_rows_ranged(rf, 50, 30)
    assert np.array_equal(win, data[:, 50:80])
    assert fetched == len(blob)


# ---------------------------------------------------------------------------
# the two command lines side by side
# ---------------------------------------------------------------------------

def _two_dirs(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    return a, b


@pytest.mark.parametrize("level", [0, 2])
def test_convert_writes_the_jax_cli_bytes(tmp_path, tif, level):
    p, data = tif
    a, b = _two_dirs(tmp_path)
    assert jax_main(["convert", str(p), "-o", str(a / "out.flac"), "-c", str(level)]) == 0
    assert main(["convert", str(p), "-o", str(b / "out.flac"), "-c", str(level)]) == 0
    assert (a / "out.flac").read_bytes() == (b / "out.flac").read_bytes()


def test_level5_files_decode_in_the_other_cli(tmp_path, tif):
    p, data = tif
    a, b = _two_dirs(tmp_path)
    assert jax_main(["convert", str(p), "-o", str(a / "out.flac")]) == 0
    assert main(["convert", str(p), "-o", str(b / "out.flac")]) == 0
    assert main(["convert", str(a / "out.flac"), "-o", str(b / "from_jax.tif")]) == 0
    assert jax_main(["convert", str(b / "out.flac"), "-o", str(a / "from_port.tif")]) == 0
    for back in (b / "from_jax.tif", a / "from_port.tif"):
        with open_geotiff(back) as src:
            assert np.array_equal(src.read(), data) and src.crs == "EPSG:4326"


def _lines(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


def test_info_prints_the_jax_cli_lines(tmp_path, tif, capsys):
    p, _ = tif
    a, b = _two_dirs(tmp_path)
    assert jax_main(["convert", str(p), "-o", str(a / "out.flac"), "-c", "0"]) == 0
    assert main(["convert", str(p), "-o", str(b / "out.flac"), "-c", "0"]) == 0
    capsys.readouterr()
    for path in ("out.flac", "../in.tif"):
        assert jax_main(["info", str(a / path)]) == 0
        jax_lines = _lines(capsys)
        assert main(["info", str(b / path)]) == 0
        assert _lines(capsys) == jax_lines and len(jax_lines) > 5


def test_query_prints_the_jax_cli_lines_and_json(tmp_path, tif, capsys):
    p, _ = tif
    a, b = _two_dirs(tmp_path)
    bbox = "-105.49,40.49,-105.40,40.5"
    for run, d in ((jax_main, a), (main, b)):
        assert run(["convert", str(p), "--spatial", "-t", "128", "-c", "0",
                    "-o", str(d / "sp.flac")]) == 0
    capsys.readouterr()
    assert jax_main(["query", str(a / "sp.flac"), "-b", bbox, "-o", str(a / "r.json")]) == 0
    jax_lines = _lines(capsys)
    assert main(["query", str(b / "sp.flac"), "-b", bbox, "-o", str(b / "r.json")]) == 0
    port_lines = _lines(capsys)
    # the last line names the JSON file written, which differs by directory
    assert port_lines[:-1] == jax_lines[:-1] and len(jax_lines) > 4
    assert json.loads((a / "r.json").read_text()) == json.loads((b / "r.json").read_text())


@pytest.mark.parametrize("argv", [
    ["convert", "in.tif"], ["info", "in.tif"], ["extract", "x.flac", "-o", "o.tif", "--last"],
    ["query", "x.flac", "-b", "0,0,1,1"], ["compare", "a.tif", "b.tif"],
])
def test_cuda_without_a_card_exits_1(argv, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_main(argv) == 1
    assert "CUDA is not available" in capsys.readouterr().err
