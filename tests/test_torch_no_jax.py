"""The port imports no JAX and nothing of the JAX package."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "flac_raster_tpu_torch"

_SLICE_IMPORTS = """
import sys
import flac_raster_tpu_torch
from flac_raster_tpu_torch import RasterFLACConverter, decode_flac, encode_flac_device
from flac_raster_tpu_torch import decode_flac_device
from flac_raster_tpu_torch import _build, interop, native
from flac_raster_tpu_torch.codec import decoder, device_decoder, device_encoder, encoder
from flac_raster_tpu_torch.models import flac_format, metadata
from flac_raster_tpu_torch.ops import device_codec, device_emit, normalization, pack, rice_cost
from flac_raster_tpu_torch.ops import bits, device_decode, device_normalize, gather, restore
from flac_raster_tpu_torch.ops import rice_group, rice_scan, stereo, wide_codec
from flac_raster_tpu_torch.ops import bitpack, crc, fixed, lpc
from flac_raster_tpu_torch import converter
from flac_raster_tpu_torch.codec import host_encoder
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flac_raster_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_slice_imports_leave_jax_out_of_sys_modules():
    res = subprocess.run(
        [sys.executable, "-c", _SLICE_IMPORTS], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax_or_the_jax_package():
    files = [f for f in sorted(PORT.rglob("*.py")) if "_build" not in f.parts]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flac_raster_tpu"), f"{f}: imports {mod}"
