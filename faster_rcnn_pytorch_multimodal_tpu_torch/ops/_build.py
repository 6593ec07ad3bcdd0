"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

The kernels have a plain C interface and are compiled by `nvcc` into one
shared library, loaded with ctypes: pointers and the stream go in as
`c_void_p`, and every entry returns `cudaGetLastError()`.  No PyTorch header
is compiled, so a build takes seconds: one `nvcc -c` per source, all started
together, then one link.

The build is lazy: importing this module never looks for `nvcc`; the first
kernel launch builds.  The library lands in `build/kernels/<hash>/` at the
root of the checkout (listed in .gitignore), keyed by a hash of the sources
and flags, so a changed `.cu` rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libfrcnn_kernels.so"

# Launches of each kernel wrapper; a wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that it went through the kernel.
LAUNCH_COUNTS = {
    "nms": 0, "roi_align": 0, "roi_align_bwd": 0, "voxelize_bev": 0,
    "roi_align_multiscale": 0, "roi_align_multiscale_bwd": 0, "nms_rotated": 0,
    "rotated_iou": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, float, str]:
    """Compile csrc/*.cu into the shared library unless it exists: one
    `nvcc -c` per source in parallel, then one link.

    Returns (path, build seconds, nvcc's output): 0 seconds and an empty log
    when the library was already there.  Raises RuntimeError if nvcc fails.
    """
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [path.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_sources(), objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(src.name, log) for src, proc, log in zip(_sources(), procs, logs) if proc.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{log}" for n, log in failed))
    tmp = path.with_name(f"{path.name}.{tag}")
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    logs.append(link.stdout + link.stderr)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    return path, seconds, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry's signature declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.frcnn_nms.argtypes = [p, p, p, i, i, f, i, p, p, p, p]
    lib.frcnn_nms.restype = i
    lib.frcnn_nms_rotated.argtypes = [p, p, p, i, i, f, i, p, p, p, p]
    lib.frcnn_nms_rotated.restype = i
    lib.frcnn_rotated_iou.argtypes = [p, p, i, i, i, p, p]
    lib.frcnn_rotated_iou.restype = i
    lib.frcnn_roi_align_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, f, i, i, i, p]
    lib.frcnn_roi_align_fwd.restype = i
    lib.frcnn_roi_align_bwd_scratch_bytes.argtypes = [i, i, i]
    lib.frcnn_roi_align_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.frcnn_roi_align_bwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
    lib.frcnn_roi_align_bwd.restype = i
    lib.frcnn_voxelize_scratch_bytes.argtypes = [i, i, i, i]
    lib.frcnn_voxelize_scratch_bytes.restype = ctypes.c_longlong
    lib.frcnn_voxelize_bev.argtypes = [p, p, p, p, i, i, f, f, f, f, f, f, f, i, i, i, i, i, f, p]
    lib.frcnn_voxelize_bev.restype = i
    # pointer arguments to host arrays: the maps or their gradients (void*[]),
    # heights, widths and scales, built by the wrapper with ctypes
    lib.frcnn_roi_align_ms_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.frcnn_roi_align_ms_fwd.restype = i
    lib.frcnn_roi_align_ms_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.frcnn_roi_align_ms_bwd.restype = i
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
