"""Time window-gather (K10) sources against each other on one CUDA card.

Each argument is ``name=path/to/gather.cu``, a source with the C entry point
``frtt_gather_windows`` of ``flac_raster_tpu_torch/csrc/gather.cu``.  Every
source is built with nvcc for sm_90a into the git-ignored
``flac_raster_tpu_torch/_build/gather_ab/``, held to the plain gather
(``ops/gather.gather_windows_reference``) on the first 4 096-frame decode
chunk of chip_smoke.py's level-5 scene (every ``word0 & 3``, body views at
+1..+3 words, windows before 0 and past the body), and then timed in turns
(A, B, ..., then in reverse, then forward again) three ways: the kernel
on the device with its inputs warm in L2 (torch.profiler over 20 launches),
on the device with the L2 cache flushed by a 256 MB write before each launch
(torch.profiler), and by CUDA events around 20 launches from ctypes.
Run it on the card from the repository root, e.g. against the parent
commit's source:

    mkdir -p _archive
    git show HEAD~1:flac_raster_tpu_torch/csrc/gather.cu > _archive/gather_parent.cu
    python3 tools/gather_ab.py parent=_archive/gather_parent.cu \
        new=flac_raster_tpu_torch/csrc/gather.cu
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flac_raster_tpu_torch import RasterFLACConverter  # noqa: E402
from flac_raster_tpu_torch.codec.device_decoder import prepare_frames  # noqa: E402
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block  # noqa: E402
from flac_raster_tpu_torch.ops import gather  # noqa: E402

OUT = ROOT / "flac_raster_tpu_torch" / "_build" / "gather_ab"


def build(sources: dict) -> dict:
    """One nvcc per source, all at once; the loaded libraries by name."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", str(src), "-o",
         str(OUT / f"{n}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, src in sources.items()}
    libs = {}
    for n, p in procs.items():
        text, _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {n}:\n{text}")
        print(f"{n}: " + "; ".join(l.split(": ", 1)[-1] for l in text.splitlines()
                                   if "Used" in l))
        lib = ctypes.CDLL(str(OUT / f"{n}.so"))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.frtt_gather_windows.argtypes = [vp, i64, vp, i64, i64, vp, vp]
        lib.frtt_gather_windows.restype = ctypes.c_int
        libs[n] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_ab: CUDA is not available", file=sys.stderr)
        return 2
    libs = build(dict(a.split("=", 1) for a in sys.argv[1:]))
    dev = torch.device("cuda", 0)
    print(cs.smi())
    scene = cs.make_raster(cs.SCENE_SIZE)
    blob = RasterFLACConverter(device="cuda", compute_md5=False).encode_array(
        scene, compression_level=cs.LEVEL)
    si, blocks, fs = parse_flac_metadata(blob)
    prep = prepare_frames(blob, fs, parse_layout_block(blocks), si, 0, 4096, dev)
    body, word0, W = prep["body"], prep["word0"], prep["W"]
    bnd = cs.bound(2 * word0.numel() * W * 4, 0)
    print(f"{word0.numel()} windows of {W} words from a {body.numel()}-word body; bound {bnd}")

    def call(lib, b, w0, out):
        err = lib.frtt_gather_windows(b.data_ptr(), b.numel(), w0.data_ptr(), w0.numel(), W,
                                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    edges = torch.tensor([s + d for s in range(4) for d in (-1 - s, -(W // 2), body.numel() - 3)],
                         device=dev)
    for n, lib in libs.items():
        for view in range(4):
            w0 = torch.cat([word0, edges]) - view
            out = torch.empty((w0.numel(), W), dtype=torch.int32, device=dev)
            call(lib, body[view:], w0, out)
            if not torch.equal(out, gather.gather_windows_reference(body[view:], w0, W)):
                raise AssertionError(f"{n} differs from the plain gather (view +{view})")
    print("every source equals the plain gather (tolerance 0)")

    out = torch.empty((word0.numel(), W), dtype=torch.int32, device=dev)
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)

    def cold(lib):
        for _ in range(20):
            flush.zero_()
            call(lib, body, word0, out)

    res = {n: {"warm": [], "l2_flushed": [], "events": []} for n in libs}
    for n in list(libs) + list(reversed(list(libs))) + list(libs):
        lib, r = libs[n], res[n]
        r["warm"].append(cs.profiled_kernel_ms(lambda: [call(lib, body, word0, out)
                                                        for _ in range(20)], "gather_windows"))
        r["l2_flushed"].append(cs.profiled_kernel_ms(lambda: cold(lib), "gather_windows"))
        r["events"].append(cs.cuda_ms(lambda: call(lib, body, word0, out), iters=20))
    for n, r in res.items():
        print(f"{n}: " + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                                   for k, v in r.items())
              + f" ms; best L2-flushed time {100 * bnd['bound_ms'] / min(r['l2_flushed']):.1f}% "
              "of the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
