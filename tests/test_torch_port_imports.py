"""The port's import boundary and kernel dispatch.

* Importing every module of the port (and its CLIs and chip_smoke.py) in a
  fresh interpreter leaves JAX, the JAX package and bench.py out of
  sys.modules: the port keeps its own copies of what it needs.
* On CPU tensors the kernel wrappers run their plain twins and launch
  nothing; on a CUDA tensor they launch the hand-written kernel, which is
  held against the twin (tests marked `cuda`, skipped without a card).

This file imports no JAX, so the `cuda` tests also run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_imports.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (  # noqa: E402
    roi_align_batched,
    roi_align_batched_plain,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (  # noqa: E402
    voxelize_bev,
    voxelize_bev_plain,
)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib.util, pkgutil, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tools!r})
import faster_rcnn_pytorch_multimodal_tpu_torch as pkg
names = [pkg.__name__]
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
for path in ({tools!r} + "/test_net_torch.py", {tools!r} + "/trainval_net_torch.py",
             {repo!r} + "/chip_smoke.py"):
    spec = importlib.util.spec_from_file_location("mod_" + str(len(names)), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
print(len(names))
leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "bench"
          or m.split(".")[0] == "faster_rcnn_pytorch_multimodal_tpu"]
assert not leaked, leaked[:10]
"""


def test_port_imports_no_jax():
    code = _IMPORT_ALL.format(repo=str(REPO), tools=str(REPO / "tools"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30  # every module of the port was imported


def _boxes(rng, shape):
    xy = rng.uniform(0, 300, shape + (2,))
    wh = rng.uniform(8, 120, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


GRID = dict(x_range=(0.0, 70.0), y_range=(-40.0, 40.0), z_range=(-3.0, 3.0), voxel_len=0.4,
            voxel_height=0.5, num_x=175, num_y=200, num_slices=12)


def _cloud(rng, b, p):
    pts = np.stack([rng.uniform(-5, 75, (b, p)), rng.uniform(-45, 45, (b, p)),
                    rng.uniform(-4, 4, (b, p)), rng.uniform(0, 1, (b, p)),
                    rng.uniform(0, 0.3, (b, p))], -1).astype(np.float32)
    n = p // 4  # on cell and slice boundaries
    pts[:, :n, 0] = rng.randint(-1, 177, (b, n)) * 0.4
    pts[:, :n, 1] = -40 + rng.randint(-1, 202, (b, n)) * 0.4
    pts[:, :n, 2] = -3 + rng.randint(-1, 14, (b, n)) * 0.5
    pts[:, n:n + 40, :3] = [10.1, 0.1, -2.9]  # 40 points in one voxel
    valid = rng.uniform(size=(b, p)) < 0.9
    valid[:, n:n + 40] = True
    return pts, valid


def test_cpu_tensors_run_the_twin_without_launching():
    rng = np.random.RandomState(0)
    before = dict(_build.LAUNCH_COUNTS)
    boxes = torch.from_numpy(_boxes(rng, (3, 120)))
    scores = torch.from_numpy(rng.uniform(size=(3, 120)).astype(np.float32))
    idx, ok = nms(boxes, scores, 0.5, 40)
    want_idx, want_ok = nms_plain(boxes, scores, 0.5, 40)
    assert torch.equal(idx, want_idx) and torch.equal(ok, want_ok)
    feats = torch.from_numpy(rng.normal(size=(2, 6, 9, 8)).astype(np.float32))
    rois = torch.from_numpy(_boxes(rng, (2, 5)))
    got = roi_align_batched(feats, rois, 1 / 16)
    assert torch.equal(got, roi_align_batched_plain(feats, rois, 1 / 16))
    feats.requires_grad_(True)
    roi_align_batched(feats, rois, 1 / 16).sum().backward()  # the twin's autograd
    assert feats.grad is not None and float(feats.grad.abs().sum()) > 0
    pts, valid = (torch.from_numpy(a) for a in _cloud(rng, 2, 3000))
    bev = voxelize_bev(pts, valid, **GRID)
    want = voxelize_bev_plain(pts, valid, **GRID)
    assert torch.equal(bev, want)
    assert bev.shape == (2, 200, 175, 15)
    assert _build.LAUNCH_COUNTS == before


def test_wrappers_reject_bad_inputs():
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        roi_align_batched(f, torch.zeros(2, 3, 4), 1 / 16)  # batch mismatch
    with pytest.raises(TypeError):
        roi_align_batched(f.double(), torch.zeros(1, 3, 4), 1 / 16)
    with pytest.raises(ValueError):
        nms(torch.zeros(5, 4), torch.zeros(6), 0.5, 3)
    with pytest.raises(TypeError):
        nms(torch.zeros(5, 4).double(), torch.zeros(5).double(), 0.5, 3)
    pts, valid = torch.zeros(2, 10, 5), torch.ones(2, 10, dtype=torch.bool)
    with pytest.raises(ValueError):
        voxelize_bev(pts[..., :4], valid, **GRID)  # not 5 values a point
    with pytest.raises(ValueError):
        voxelize_bev(pts[0], valid[0], **GRID)  # one frame without its batch axis
    with pytest.raises(ValueError):
        voxelize_bev(pts, valid[:, :9], **GRID)  # valid does not fit the points
    with pytest.raises(TypeError):
        voxelize_bev(pts.double(), valid, **GRID)
    with pytest.raises(TypeError):
        voxelize_bev(pts, valid.float(), **GRID)
    with pytest.raises(ValueError):
        voxelize_bev(pts, valid, **{**GRID, "num_slices": 0})


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,thr,max_out", [(8, 2048, 0.7, 300), (16, 300, 0.6, 100), (3, 70, 0.5, 70)])
def test_nms_kernel_matches_twin(cuda, g, n, thr, max_out):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, (g, n))
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    scores[0] = np.round(scores[0] * 4) / 4  # ties
    valid = rng.uniform(size=(g, n)) < 0.8
    args = [torch.from_numpy(a) for a in (boxes, scores)]
    v = torch.from_numpy(valid)
    before = _build.LAUNCH_COUNTS["nms"]
    idx, ok = nms(args[0].to(cuda), args[1].to(cuda), thr, max_out, v.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["nms"] == before + 1
    want_idx, want_ok = nms_plain(*args, thr, max_out, v)
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(ok.cpu(), want_ok)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,tol", [(torch.float32, 1024, 1e-5), (torch.bfloat16, 1024, 1e-2),
                                         (torch.float32, 30, 1e-5), (torch.bfloat16, 12, 1e-2)])
def test_roi_align_kernel_matches_twin(cuda, dtype, c, tol):
    """Vectorized (C a multiple of 16 bytes) and scalar channel paths; bf16
    bound 1e-2 * max|F| because the output is rounded to bf16."""
    rng = np.random.RandomState(c)
    feats = torch.from_numpy(rng.normal(size=(2, 32, 60, c)).astype(np.float32)).to(dtype)
    rois = _boxes(rng, (2, 64))
    rois[:, :8] -= 150.0  # straddling the top-left edge
    rois[:, 8:12] += 2000.0  # outside the map
    rois = torch.from_numpy(rois)
    got = roi_align_batched(feats.to(cuda), rois.to(cuda), 1 / 16)
    torch.cuda.synchronize()
    want = roi_align_batched_plain(feats, rois, 1 / 16)
    assert got.dtype == dtype and got.shape == (2, 64, 7, 7, c)
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol * float(feats.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,tol", [(torch.float32, 1024, 1e-5), (torch.bfloat16, 1024, 1e-2),
                                         (torch.float32, 30, 1e-5), (torch.bfloat16, 12, 1e-2)])
def test_roi_align_backward_kernel_matches_twin(cuda, dtype, c, tol):
    """The feature gradient of the CUDA path (backward kernel, float32
    atomics, run-to-run order) against the twin's autograd gradient, within
    tol * max|dF|; the rois get no gradient."""
    rng = np.random.RandomState(c + 1)
    feats = torch.from_numpy(rng.normal(size=(2, 32, 60, c)).astype(np.float32)).to(dtype)
    rois = _boxes(rng, (2, 64))
    rois[:, :8] -= 150.0
    rois[:, 8:12] += 2000.0
    rois = torch.from_numpy(rois)
    g = torch.from_numpy(rng.normal(size=(2, 64, 7, 7, c)).astype(np.float32)).to(dtype)
    f_dev = feats.to(cuda).requires_grad_(True)
    r_dev = rois.to(cuda).requires_grad_(True)
    before = _build.LAUNCH_COUNTS["roi_align_bwd"]
    roi_align_batched(f_dev, r_dev, 1 / 16).backward(g.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["roi_align_bwd"] == before + 1
    assert r_dev.grad is None
    f_cpu = feats.clone().requires_grad_(True)
    roi_align_batched_plain(f_cpu, rois, 1 / 16).backward(g)
    want = f_cpu.grad.float()
    assert f_dev.grad.dtype == dtype
    err = float((f_dev.grad.cpu().float() - want).abs().max())
    assert err <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_voxelize_kernel_matches_twin(cuda):
    """Height and density channels equal, the meta channels (float sums in
    atomic order) within 1e-5; an all-invalid frame stays zero."""
    rng = np.random.RandomState(3)
    pts, valid = _cloud(rng, 3, 20000)
    valid[2] = False
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    before = _build.LAUNCH_COUNTS["voxelize_bev"]
    got = voxelize_bev(tp.to(cuda), tv.to(cuda), **GRID)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["voxelize_bev"] == before + 1
    want = voxelize_bev_plain(tp, tv, **GRID)
    got = got.cpu()
    assert torch.equal(got[..., :13], want[..., :13])
    assert float((got[..., 13:] - want[..., 13:]).abs().max()) <= 1e-5
    assert not bool(got[2].any())
