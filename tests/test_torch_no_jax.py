"""The port imports no JAX and nothing of the JAX package."""

import ast
import pathlib
import re
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
from flac_raster_tpu_torch import compare
from flac_raster_tpu_torch.io import geo, geotiff, remote
from flac_raster_tpu_torch.models import spatial, streaming
from flac_raster_tpu_torch import parallel
from flac_raster_tpu_torch.parallel import decode_mesh, mesh, multihost, tile_engine
from flac_raster_tpu_torch import cli, utils, __main__
from flac_raster_tpu_torch.utils import profiling, selftest
try:
    from flac_raster_tpu_torch.io import async_reader
except ImportError:    # no aiohttp (the card's machine): the package says so
    assert flac_raster_tpu_torch.ASYNC_GEOTIFF_AVAILABLE is False
    assert flac_raster_tpu_torch.AsyncGeoTIFFReader is None
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


def test_slice_imports_without_requests_obstore_or_aiohttp():
    """The card's machine has none of the remote layer's optional packages:
    every module of the port, and chip_smoke.py, imports without them."""
    blocked = ("import sys\n"
               "for m in ('requests', 'obstore', 'aiohttp'):\n"
               "    sys.modules[m] = None\n")
    res = subprocess.run(
        [sys.executable, "-c", blocked + _SLICE_IMPORTS], cwd=ROOT,
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


_JAX_FILE = re.compile(r"(^|/)flac_raster_tpu/[\w./-]*\.(py|cpp|cc|c|h|so|json)$")
_PATH_CALLS = {"Path", "PurePath", "open", "join", "joinpath", "read_text", "read_bytes"}


def _docstrings(tree):
    """The string statements (docstrings and bare strings): prose, not paths."""
    return {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)
            and isinstance(n.value.value, str)}


def _names_jax_package(value) -> bool:
    return isinstance(value, str) and (value.strip("/") == "flac_raster_tpu"
                                       or value.startswith("flac_raster_tpu/")
                                       or "/flac_raster_tpu/" in value)


def _jax_path_reads(source: str) -> list[str]:
    """Where a source names a path under the JAX package: a string literal
    that is a file of it, a ``Path``/``open``/``join`` call or a ``/`` join
    with a literal naming it."""
    tree = ast.parse(source)
    prose = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and id(node) not in prose:
            if isinstance(node.value, str) and _JAX_FILE.search(node.value):
                found.append(f"line {node.lineno}: {node.value!r}")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) and _names_jax_package(side.value):
                    found.append(f"line {node.lineno}: / {side.value!r}")
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
            if name in _PATH_CALLS:
                for arg in [*node.args, *(k.value for k in node.keywords)]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Constant) and _names_jax_package(sub.value):
                            found.append(f"line {node.lineno}: {name}({sub.value!r})")
    return found


def test_path_check_flags_a_read_of_the_jax_package():
    """The check below finds the ways a source could reach a JAX package
    file, and passes a docstring or a ``file:line`` reference."""
    reads = [
        'SRC = Path(__file__).resolve().parent.parent / "flac_raster_tpu" / "native"',
        'lib = os.path.join(ROOT, "flac_raster_tpu", "native", "bitpack.cpp")',
        'text = open("flac_raster_tpu/ops/crc.py").read()',
        'SRC = "flac_raster_tpu/native/plan.cpp"',
        'p = ROOT.joinpath("flac_raster_tpu/native")',
    ]
    for line in reads:
        assert _jax_path_reads(line), line
    prose = ('"""Copied from ``flac_raster_tpu/native/bitpack.cpp``."""\n'
             'REPLACES = "flac_raster_tpu/ops/pallas_pack.py:372"\n')
    assert _jax_path_reads(prose) == []


def test_no_source_file_reads_a_path_of_the_jax_package():
    """The port keeps its own copy of what it needs (its host C runtime
    is ``csrc/host/bitpack.cpp``): no source of it, and nothing in
    chip_smoke.py, names a file under ``flac_raster_tpu/`` to read."""
    files = [f for f in sorted(PORT.rglob("*.py")) if "_build" not in f.parts]
    files.append(ROOT / "chip_smoke.py")
    bad = {str(f.relative_to(ROOT)): r for f in files if (r := _jax_path_reads(f.read_text()))}
    assert bad == {}
