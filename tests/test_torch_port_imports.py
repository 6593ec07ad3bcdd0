"""The port's import boundary and kernel dispatch.

* Importing every module of the port (and its CLI and chip_smoke.py) in a
  fresh interpreter leaves JAX out of sys.modules.
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
assert "jax" not in sys.modules, [m for m in sys.modules if m.startswith("jax")][:5]
"""


def test_port_imports_no_jax():
    code = _IMPORT_ALL.format(repo=str(REPO), tools=str(REPO / "tools"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 22  # every module of the port was imported


def _boxes(rng, shape):
    xy = rng.uniform(0, 300, shape + (2,))
    wh = rng.uniform(8, 120, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


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
