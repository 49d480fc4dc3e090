"""Host C runtime of the port: CRC patching, the native frame decoder, the
residual decoder of the Python frame walk, and the interleave of band planes
into the STREAMINFO MD5's PCM rows.

The C source is the port's own, ``csrc/host/bitpack.cpp`` (the parts of
the JAX package's host runtime that the CRC and decode entry points need,
copied, and the interleave),
compiled with ``g++ -O3 -shared -fPIC`` into the port's git-ignored build
directory.

A failed build raises: there is no per-byte Python CRC fallback, which
would take minutes on a full-size raster.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["crc8_patch", "crc16_patch", "crc16_spans", "decode_frames", "decode_residual",
           "interleave_planes"]

_SRCS = (Path(__file__).resolve().parent / "csrc" / "host" / "bitpack.cpp",)
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_CMD = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(_CMD).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the host library if no build of the current sources exists.

    Keyed by a content hash of the sources and the command.  A file lock
    serialises concurrent builds (parallel test workers); the library appears
    under its final name only once complete.
    """
    missing = [str(s) for s in _SRCS if not s.exists()]
    if missing:
        raise RuntimeError(f"host C sources not found: {missing}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libfrtt_host-{_digest()}.so"
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [*_CMD, *map(str, _SRCS), "-o", str(tmp)]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(
                    f"host C build failed ({' '.join(cmd)}):\n{res.stderr}"
                )
            os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.crc8_patch_spans_c.argtypes = [u8p, i64p, i64p, ctypes.c_int64]
    lib.crc8_patch_spans_c.restype = None
    lib.crc16_patch_spans_c.argtypes = [u8p, i64p, i64p, ctypes.c_int64]
    lib.crc16_patch_spans_c.restype = None
    lib.crc16_spans_check_c.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16),
    ]
    lib.crc16_spans_check_c.restype = None
    lib.decode_frames_c.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), i64p, i64p,
        ctypes.c_int64, i64p,
    ]
    lib.decode_frames_c.restype = ctypes.c_int64
    lib.decode_residual_c.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p,
    ]
    lib.decode_residual_c.restype = ctypes.c_int64
    lib.interleave_planes_c.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32,
        u8p,
    ]
    lib.interleave_planes_c.restype = ctypes.c_int32
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _spans(buf: np.ndarray, starts, lens):
    if buf.dtype != np.uint8 or buf.ndim != 1 or not buf.flags.c_contiguous:
        raise ValueError("buf must be a contiguous 1-D uint8 array")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if starts.shape != lens.shape:
        raise ValueError("starts and lens differ in shape")
    return starts, lens


def crc8_patch(buf: np.ndarray, starts, lens) -> None:
    """For each span, write crc8(buf[start:start+len]) at buf[start+len]."""
    starts, lens = _spans(buf, starts, lens)
    if len(starts) and int((starts + lens).max()) >= buf.size:
        raise ValueError("CRC-8 span past the buffer")
    _load().crc8_patch_spans_c(
        _ptr(buf, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), len(starts),
    )


def crc16_patch(buf: np.ndarray, starts, lens) -> None:
    """For each span, write the big-endian crc16 at buf[start+len:+2]."""
    starts, lens = _spans(buf, starts, lens)
    if len(starts) and int((starts + lens).max()) + 1 >= buf.size:
        raise ValueError("CRC-16 span past the buffer")
    _load().crc16_patch_spans_c(
        _ptr(buf, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), len(starts),
    )


def crc16_spans(buf: np.ndarray, starts, lens) -> np.ndarray:
    """CRC-16 of each span (verification side; no patching)."""
    starts, lens = _spans(buf, starts, lens)
    if len(starts) and int((starts + lens).max()) > buf.size:
        raise ValueError("CRC-16 span past the buffer")
    out = np.empty(len(starts), dtype=np.uint16)
    _load().crc16_spans_check_c(
        _ptr(buf, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), len(starts), _ptr(out, ctypes.c_uint16),
    )
    return out


def decode_frames(
    buf: np.ndarray,
    start_byte: int,
    expected_samples: int,
    channels: int,
    bits_per_sample: int,
):
    """Decode every frame of a stream in one native pass.

    Returns (samples (expected, channels) int32, frame_starts, frame_sizes),
    or None when the native decoder cannot handle the stream.
    """
    if buf.dtype != np.uint8 or buf.ndim != 1 or not buf.flags.c_contiguous:
        raise ValueError("buf must be a contiguous 1-D uint8 array")
    out = np.empty((expected_samples, channels), dtype=np.int32)
    cap = expected_samples // 16 + 4
    starts = np.empty(cap, dtype=np.int64)
    sizes = np.empty(cap, dtype=np.int64)
    n_frames = np.zeros(1, dtype=np.int64)
    total = _load().decode_frames_c(
        _ptr(buf, ctypes.c_uint8), buf.size, start_byte,
        expected_samples, channels, bits_per_sample,
        _ptr(out, ctypes.c_int32), _ptr(starts, ctypes.c_int64),
        _ptr(sizes, ctypes.c_int64), cap, _ptr(n_frames, ctypes.c_int64),
    )
    if total != expected_samples or n_frames[0] > cap:
        return None
    nf = int(n_frames[0])
    return out, starts[:nf], sizes[:nf]


def decode_residual(buf: np.ndarray, bit_pos: int, blocksize: int, order: int):
    """Decode one subframe's residual section (4- or 5-bit Rice parameters,
    escape partitions) starting at the absolute bit ``bit_pos`` of ``buf``.

    Returns (blocksize - order residuals int64, the bit offset past them);
    raises ValueError on a malformed or truncated section.
    """
    if buf.dtype != np.uint8 or buf.ndim != 1 or not buf.flags.c_contiguous:
        raise ValueError("buf must be a contiguous 1-D uint8 array")
    out = np.empty(blocksize - order, dtype=np.int64)
    end = _load().decode_residual_c(
        _ptr(buf, ctypes.c_uint8), buf.size * 8, bit_pos, blocksize, order,
        _ptr(out, ctypes.c_int64),
    )
    if end < 0:
        raise ValueError("corrupt Rice stream" if end == -2
                         else "invalid residual coding parameters")
    return out, int(end)


def interleave_planes(planes: np.ndarray, flip: int, out: np.ndarray) -> np.ndarray:
    """The (k, C) rows of C band planes, (C, k) samples of 1, 2 or 4 bytes
    whose planes are each contiguous, each sample xor ``flip``, written into
    ``out`` (a contiguous 1-D array of at least k * C samples of the
    planes' itemsize); returns the k * C samples written, as ``out``'s
    dtype.  The planes' bytes are taken as they lie (little-endian)."""
    C, k = planes.shape
    width = planes.itemsize
    if width not in (1, 2, 4) or out.itemsize != width:
        raise ValueError(f"samples of {width} bytes into {out.itemsize}-byte samples")
    if k > 1 and planes.strides[1] != width:
        raise ValueError("each plane must be contiguous")
    if out.ndim != 1 or not out.flags.c_contiguous or out.size < k * C:
        raise ValueError("out must be a contiguous 1-D array of k * C samples")
    if not 0 <= flip < 1 << (8 * width):
        raise ValueError(f"flip {flip} exceeds {width} bytes")
    if k and C:
        _load().interleave_planes_c(
            _ptr(planes, ctypes.c_uint8), planes.strides[0], C, k, width, flip,
            _ptr(out, ctypes.c_uint8))
    return out[: k * C]
