"""ctypes wrapper over the host point-cloud ops of csrc/pc_ops.cpp.

The port's copy of faster_rcnn_pytorch_multimodal_tpu/native/pc_ops.py, with
one difference: there is no fallback.  The library is built at first use
with the compiler in $CXX (g++ by default) and the flags of the JAX
package's native/Makefile, into build/native/<hash>/ at the root of the
checkout (listed in .gitignore), keyed by a hash of the source, the
compiler, the flags and what -march=native resolves to on this machine, so
a copy of the tree moved to another host builds its own.  A failed build
raises RuntimeError with the compiler's output: the random ops draw from
the library's generator, and a numpy stand-in would give other points for
the same seed.

The numpy versions of the deterministic ops (`*_plain`) are the plain
twins the tests hold the library against; the random ops (gauss jitter,
dropout, rain) have none, and are held against the JAX package's library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pc_ops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")  # native/Makefile
LIB_NAME = "libpc_ops.so"

_lock = threading.Lock()


def _cxx() -> list[str]:
    return shlex.split(os.environ.get("CXX", "g++"))


def _native_flags(cxx: list[str]) -> str:
    """What -march=native resolves to (the compiler's target options), so
    that the library's key changes with the host's CPU."""
    try:
        proc = subprocess.run([*cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"pc_ops: cannot run the compiler {cxx}: {e}") from e
    return proc.stdout + proc.stderr


def library_path() -> Path:
    cxx = _cxx()
    h = hashlib.sha256(" ".join(cxx + list(CXX_FLAGS)).encode())
    h.update(_native_flags(cxx).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile csrc/pc_ops.cpp unless its library exists; raises
    RuntimeError with the compiler's output if the compiler fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [*_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"pc_ops: {shlex.join(cmd)} did not run: {e}") from e
    if proc.returncode or not tmp.exists():
        raise RuntimeError(f"pc_ops: {shlex.join(cmd)} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    return path


@functools.lru_cache(maxsize=None)
def _load_locked() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i, f, u64 = ctypes.c_int, ctypes.c_float, ctypes.c_uint64
    lib.pc_range_filter.restype = i
    lib.pc_range_filter.argtypes = [f32p, i, i, f32p]
    lib.pc_gauss_distort.restype = None
    lib.pc_gauss_distort.argtypes = [f32p, i, i, f32p, u64]
    lib.pc_dropout.restype = i
    lib.pc_dropout.argtypes = [f32p, i, i, f, u64]
    lib.pc_rotate_z.restype = None
    lib.pc_rotate_z.argtypes = [f32p, i, i, f]
    lib.pc_flip_y.restype = None
    lib.pc_flip_y.argtypes = [f32p, i, i]
    lib.pc_flip_x.restype = None
    lib.pc_flip_x.argtypes = [f32p, i, i, f]
    lib.pc_swap_xy.restype = None
    lib.pc_swap_xy.argtypes = [f32p, i, i, f, f]
    lib.pc_rain_sim.restype = i
    lib.pc_rain_sim.argtypes = [f32p, i, i, f, f, u64]
    return lib


def library() -> ctypes.CDLL:
    """The loaded library (built on the first call)."""
    with _lock:
        return _load_locked()


def _prep(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, dtype=np.float32)
    return pts if pts is not points else pts.copy()


def pc_range_filter(points: np.ndarray, bounds) -> np.ndarray:
    """Keep points inside [x0,x1]x[y0,y1]x[z0,z1]."""
    lib = library()
    pts = _prep(points)
    n = lib.pc_range_filter(pts, len(pts), pts.shape[1], np.ascontiguousarray(bounds, np.float32))
    return pts[:n]


def pc_gauss_distort(points: np.ndarray, sigmas, seed: int) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    lib.pc_gauss_distort(pts, len(pts), pts.shape[1], np.ascontiguousarray(sigmas, np.float32),
                         seed)
    return pts


def pc_dropout(points: np.ndarray, p_keep: float, seed: int) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    n = lib.pc_dropout(pts, len(pts), pts.shape[1], p_keep, seed)
    return pts[:n]


def pc_rotate_z(points: np.ndarray, angle: float) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    lib.pc_rotate_z(pts, len(pts), pts.shape[1], angle)
    return pts


def pc_flip_y(points: np.ndarray) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    lib.pc_flip_y(pts, len(pts), pts.shape[1])
    return pts


def pc_flip_x(points: np.ndarray, x_max: float) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    lib.pc_flip_x(pts, len(pts), pts.shape[1], x_max)
    return pts


def pc_swap_xy(points: np.ndarray, y_min: float, x_range_mean: float) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    lib.pc_swap_xy(pts, len(pts), pts.shape[1], y_min, x_range_mean)
    return pts


def pc_rain_sim(points: np.ndarray, rain_rate: float, max_range: float, seed: int) -> np.ndarray:
    lib = library()
    pts = _prep(points)
    n = lib.pc_rain_sim(pts, len(pts), pts.shape[1], rain_rate, max_range, seed)
    return pts[:n]


# -- plain twins of the deterministic ops (the JAX wrapper's numpy branches) --


def pc_range_filter_plain(points: np.ndarray, bounds) -> np.ndarray:
    b = np.ascontiguousarray(bounds, np.float32)
    m = (
        (points[:, 0] >= b[0]) & (points[:, 0] <= b[1])
        & (points[:, 1] >= b[2]) & (points[:, 1] <= b[3])
        & (points[:, 2] >= b[4]) & (points[:, 2] <= b[5])
    )
    return points[m]


def pc_rotate_z_plain(points: np.ndarray, angle: float) -> np.ndarray:
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.augment import rotate_points_along_z

    return rotate_points_along_z(points, angle)


def pc_flip_y_plain(points: np.ndarray) -> np.ndarray:
    pts = _prep(points)
    pts[:, 1] *= -1
    return pts


def pc_flip_x_plain(points: np.ndarray, x_max: float) -> np.ndarray:
    pts = _prep(points)
    pts[:, 0] = -pts[:, 0] + x_max
    return pts


def pc_swap_xy_plain(points: np.ndarray, y_min: float, x_range_mean: float) -> np.ndarray:
    pts = _prep(points)
    x, y = pts[:, 0].copy(), pts[:, 1].copy()
    pts[:, 0] = y - y_min
    pts[:, 1] = x - x_range_mean
    return pts
