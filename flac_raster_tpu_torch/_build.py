"""Build and load the port's Hopper kernels (``csrc/*.cu``).

nvcc compiles each CUDA source to an object for ``sm_90a``, all sources at
once in parallel processes, and links the objects into one shared library
with a plain C interface, which is loaded with ctypes::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   # one per source
    nvcc -shared *.o -o _build/kernels-<hash>/libfrtt_kernels.so

The build runs at first use (so ``python3 chip_smoke.py`` alone builds
everything), is keyed by a content hash of the sources and the command, and
goes into the git-ignored ``_build`` directory.  nvcc's output, including
ptxas's register and spill report, stays beside the library in
``nvcc.log``.  Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "kernels", "check", "nvcc_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lib = None


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _out_dir() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile the kernel library unless a build of these sources exists."""
    out = _out_dir()
    lib_path = out / "libfrtt_kernels.so"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile_and_link(out, lib_path)
    return lib_path


def _compile_and_link(out: Path, lib_path: Path) -> None:
    nvcc = _nvcc()
    cmds = [[nvcc, *_FLAGS, "-c", str(src), "-o", str(out / f"{src.stem}.o")]
            for src in _sources()]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            text, _ = proc.communicate(timeout=900)
            logs.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(text)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out / f"libfrtt_kernels.{os.getpid()}.tmp"
    if not failed:
        link = [nvcc, "-shared", *(c[-1] for c in cmds), "-o", str(tmp)]
        res = subprocess.run(link, capture_output=True, text=True, timeout=300)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    (out / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)


def nvcc_log() -> str:
    """nvcc's output for the current build (ptxas resource report)."""
    p = _out_dir() / "nvcc.log"
    return p.read_text() if p.exists() else ""


def kernels():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.frtt_rice_cost_sums.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    lib.frtt_rice_cost_sums.restype = ctypes.c_int
    lib.frtt_pack_tokens.argtypes = [vp, vp, vp, i64, vp, i64, vp]
    lib.frtt_pack_tokens.restype = ctypes.c_int
    for name, extra in (("v2", [vp]), ("v3", [i32, vp]), ("v4", [vp]), ("v5", [])):
        fn = getattr(lib, f"frtt_pack_tokens_{name}")
        fn.argtypes = [vp, vp, vp, i64, vp, i64, *extra, vp]
        fn.restype = ctypes.c_int
    lib.frtt_gather_windows.argtypes = [vp, i64, vp, i64, i64, vp, vp]
    lib.frtt_gather_windows.restype = ctypes.c_int
    lib.frtt_rice_scan_full.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp, vp, vp, i32,
                                        vp, vp, vp, vp]
    lib.frtt_rice_scan_full.restype = ctypes.c_int
    lib.frtt_rice_group_step.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                         i32, vp, vp]
    lib.frtt_rice_group_step.restype = ctypes.c_int
    lib.frtt_rice_group_scan.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                         i32, vp, vp]
    lib.frtt_rice_group_scan.restype = ctypes.c_int
    lib.frtt_restore.argtypes = [vp, i64, i32, vp, vp, vp, vp, i32, vp, vp]
    lib.frtt_restore.restype = ctypes.c_int
    lib.frtt_error_string.argtypes = [ctypes.c_int]
    lib.frtt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        msg = kernels().frtt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
