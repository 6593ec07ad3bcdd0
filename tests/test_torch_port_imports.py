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

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (  # noqa: E402
    _multiscale_roi_align_cuda,
    multiscale_roi_align,
    multiscale_roi_align_batched,
    multiscale_roi_align_batched_plain,
    roi_align_batched,
    roi_align_batched_plain,
    roi_levels,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (  # noqa: E402
    rotated_iou_matrix,
    rotated_iou_matrix_plain,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (  # noqa: E402
    voxelize_bev,
    voxelize_bev_plain,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

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


def test_rotated_cpu_runs_the_twin_without_launching():
    """nms(rotated=True) and rotated_iou_matrix on CPU tensors: the twin."""
    rng = np.random.RandomState(6)
    boxes = torch.from_numpy(chip_smoke.rotated_boxes(rng, 2, 90))
    scores = torch.from_numpy(rng.uniform(size=(2, 90)).astype(np.float32))
    before = dict(_build.LAUNCH_COUNTS)
    idx, ok = nms(boxes, scores, 0.3, 30, rotated=True)
    want_idx, want_ok = nms_plain(boxes, scores, 0.3, 30, rotated=True)
    assert torch.equal(idx, want_idx) and torch.equal(ok, want_ok)
    assert torch.equal(rotated_iou_matrix(boxes, boxes), rotated_iou_matrix_plain(boxes, boxes))
    assert _build.LAUNCH_COUNTS == before


FPN_HW = [(32, 48), (16, 24), (8, 12), (4, 6)]  # p2..p5 of a 128x192 frame
STRIDES = (4, 8, 16, 32)


def _fpn_rois(rng, b, r, lo=8.0, hi=700.0):
    """Log-uniform sides, so RoIs land on every level; some straddle the
    frame's edge or lie outside it."""
    x1 = rng.uniform(-30, 192, (b, r))
    y1 = rng.uniform(-30, 128, (b, r))
    side = np.exp(rng.uniform(np.log(lo), np.log(hi), (b, r)))
    aspect = np.exp(rng.uniform(-1, 1, (b, r)))
    rois = np.stack([x1, y1, x1 + side * aspect, y1 + side / aspect], -1)
    rois[:, :4] += 3000.0  # outside every map
    return rois.astype(np.float32)


def test_multiscale_cpu_runs_the_twin_without_launching():
    rng = np.random.RandomState(4)
    before = dict(_build.LAUNCH_COUNTS)
    maps = [torch.from_numpy(rng.normal(size=(2,) + hw + (8,)).astype(np.float32)).requires_grad_(True)
            for hw in FPN_HW]
    rois = torch.from_numpy(_fpn_rois(rng, 2, 30))
    got = multiscale_roi_align_batched(maps, rois, STRIDES)
    assert torch.equal(got, multiscale_roi_align_batched_plain(maps, rois, STRIDES))
    assert torch.equal(multiscale_roi_align([m[1] for m in maps], rois[1], STRIDES), got[1])
    assert set(roi_levels(rois, 4).unique().tolist()) == {0, 1, 2, 3}
    got.sum().backward()  # the twin's autograd, into every level
    assert all(float(m.grad.abs().sum()) > 0 for m in maps)
    assert _build.LAUNCH_COUNTS == before


def test_multiscale_wrapper_rejects_bad_inputs():
    maps = [torch.zeros((1,) + hw + (8,)) for hw in FPN_HW]
    rois = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError):
        multiscale_roi_align_batched(maps, rois, STRIDES[:3])  # a stride short
    with pytest.raises(ValueError):
        multiscale_roi_align_batched(maps + maps[:1], rois, STRIDES + (64,))  # five levels
    with pytest.raises(ValueError):
        multiscale_roi_align_batched(maps, torch.zeros(2, 3, 4), STRIDES)  # batch mismatch
    with pytest.raises(ValueError):
        multiscale_roi_align_batched(maps[:3] + [torch.zeros(1, 4, 6, 16)], rois, STRIDES)  # C
    with pytest.raises(ValueError):
        multiscale_roi_align_batched(maps[:3] + [maps[3].bfloat16()], rois, STRIDES)  # dtype
    with pytest.raises(TypeError):
        multiscale_roi_align_batched([m.double() for m in maps], rois, STRIDES)


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


def _bwd_rois(rng, b, r, h, w):
    """RoIs on an (h, w) stride-16 map: random ones, some straddling the
    top-left edge, some outside the map, some smaller than a cell and one
    covering the whole map."""
    rois = _boxes(rng, (b, r)) * np.float32(max(h / 32, w / 60, 1.0))
    rois[:, :8] -= 150.0  # straddling the top-left edge
    rois[:, 8:12] += 16.0 * max(h, w) + 100.0  # outside the map
    rois[:, 12:20, 2:] = rois[:, 12:20, :2] + rng.uniform(1, 12, (b, 8, 2))  # under a cell
    rois[:, 20] = [0, 0, 16 * w, 16 * h]  # the whole map
    return torch.from_numpy(rois.astype(np.float32))


def _check_backward(cuda, dtype, b, h, w, c, r, seed):
    """The CUDA path's feature gradient against the twin's autograd gradient
    on the CPU: every element within chip_smoke's sum-order limit, the
    rois without gradient, one launch, and a second run bitwise equal."""
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dtype)
    rois = _bwd_rois(rng, b, r, h, w) if r else torch.zeros(b, 0, 4)
    g = torch.from_numpy(rng.normal(size=(b, r, 7, 7, c)).astype(np.float32)).to(dtype)
    f_dev = feats.to(cuda).requires_grad_(True)
    r_dev = rois.to(cuda).requires_grad_(True)
    before = _build.LAUNCH_COUNTS["roi_align_bwd"]
    roi_align_batched(f_dev, r_dev, 1 / 16).backward(g.to(cuda))
    again = f_dev.grad.clone()
    f_dev.grad = None
    roi_align_batched(f_dev, r_dev, 1 / 16).backward(g.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["roi_align_bwd"] == before + 2
    assert r_dev.grad is None
    assert f_dev.grad.dtype == dtype and torch.equal(f_dev.grad, again)
    f_cpu = feats.clone().requires_grad_(True)
    roi_align_batched_plain(f_cpu, rois, 1 / 16).backward(g)
    (limit,) = chip_smoke.sum_order_tolerance(
        lambda xs: roi_align_batched_plain(xs[0], rois, 1 / 16), [feats], g, dtype)
    assert chip_smoke.limit_ratio(f_dev.grad.cpu(), f_cpu.grad, limit) <= 1.0
    return f_cpu.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [(torch.float32, 1024), (torch.bfloat16, 1024),
                                     (torch.float32, 30), (torch.bfloat16, 12)])
def test_roi_align_backward_kernel_matches_twin(cuda, dtype, c):
    """The feature gradient of the CUDA path (the tile-gather kernel, 4
    channels a thread where C allows, else one) against the twin's autograd
    gradient within the sum-order limit, bitwise equal on a second run."""
    _check_backward(cuda, dtype, 2, 32, 60, c, 64, c + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_on_a_large_map(cuda, dtype):
    """An 80 x 120 map (a 1280 x 1920 frame): more tiles than the training
    maps, RoIs over the whole map and under a cell."""
    _check_backward(cuda, dtype, 2, 80, 120, 64, 96, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_without_rois_is_zero(cuda, dtype):
    """R = 0: the kernel still writes every element, all zero."""
    want = _check_backward(cuda, dtype, 2, 9, 13, 8, 0, 3)
    assert not bool(want.any())


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,max_out,case", [
    (4, 77, 30, "n not a multiple of 64"), (4, 130, 130, "max_out = n: the slots never fill"),
    (4, 200, 1, "max_out 1"), (3, 150, 50, "one problem all invalid"),
    (2, 6000, 6000, "6000 lanes: 94 mask words a row"),
    (1, 12000, 12000, "12000 lanes: two staging buffers fit, not three"),
    (1, 20000, 300, "20000 lanes: one staging buffer")])
def test_nms_kernel_edge_cases_match_twin(cuda, g, n, max_out, case):
    """The staged block scan on the shapes that stress it: the keeps, their
    order and the padding identical to the twin's."""
    rng = np.random.RandomState(n + max_out)
    boxes = _boxes(rng, (g, n))
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    scores[0] = np.round(scores[0] * 4) / 4  # ties
    valid = rng.uniform(size=(g, n)) < 0.8
    if case.startswith("one problem"):
        valid[1] = False
    args = [torch.from_numpy(a) for a in (boxes, scores)]
    v = torch.from_numpy(valid)
    idx, ok = nms(args[0].to(cuda), args[1].to(cuda), 0.5, max_out, v.to(cuda))
    torch.cuda.synchronize()
    want_idx, want_ok = nms_plain(*args, 0.5, max_out, v)
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(ok.cpu(), want_ok), case
    if case.startswith("one problem"):
        assert not bool(ok[1].any()) and not bool(idx[1].any())


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


def _voxelize_against_twin(cuda, pts, valid, grid, num_meta=3):
    """Two kernel runs against the twin: heights and density equal to the
    twin's and to each other, the meta channels within 1e-5 (float sums in
    arrival order).  Returns the kernel's raster on the CPU."""
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    kw = {**grid, "num_meta": num_meta}
    before = _build.LAUNCH_COUNTS["voxelize_bev"]
    got = voxelize_bev(tp.to(cuda), tv.to(cuda), **kw)
    again = voxelize_bev(tp.to(cuda), tv.to(cuda), **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["voxelize_bev"] == before + 2
    want = voxelize_bev_plain(tp, tv, **kw)
    got, again = got.cpu(), again.cpu()
    exact = grid["num_slices"] + min(num_meta, 1)
    assert got.shape == want.shape
    assert torch.equal(got[..., :exact], want[..., :exact])
    assert torch.equal(got[..., :exact], again[..., :exact])
    if num_meta >= 2:
        assert float((got[..., exact:] - want[..., exact:]).abs().max()) <= 1e-5
    return got


@pytest.mark.cuda
def test_voxelize_kernel_on_one_tile_repeats(cuda):
    """Frame 0's 20,000 points all in one 8 x 32 tile (many rounds of the
    tile block's list walk), 40 of them in one voxel: equal to the twin and
    over two runs, the over-full voxel's density capped at 1.0, the
    all-invalid frame zero."""
    rng = np.random.RandomState(21)
    pts, valid = chip_smoke.skew_points(rng, 3, 20000, GRID)
    got = _voxelize_against_twin(cuda, pts, valid, GRID)
    assert float(got[0, 24:32, 64:96, 12].max()) == 1.0
    assert not bool(got[0, :24].any()) and not bool(got[0, :, :64].any())
    assert not bool(got[1].any())


@pytest.mark.cuda
def test_voxelize_kernel_at_800x700(cuda):
    """The Waymo-size raster (the BEV config at frame scale 1.0)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs

    grid = raster_kwargs(chip_smoke.make_config(chip_smoke.BEV_OVERRIDES), 1.0)
    assert (grid["num_y"], grid["num_x"]) == (800, 700)
    pts, valid = chip_smoke.bev_points(np.random.RandomState(22), 2, 60000, grid)
    got = _voxelize_against_twin(cuda, pts, valid, grid, grid["num_meta"])
    assert not bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("num_meta", [0, 1, 2, 3])
def test_voxelize_kernel_num_meta(cuda, num_meta):
    rng = np.random.RandomState(23 + num_meta)
    pts, valid = _cloud(rng, 2, 8000)
    got = _voxelize_against_twin(cuda, pts, valid, GRID, num_meta)
    assert got.shape == (2, 200, 175, 12 + num_meta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,tol", [(torch.float32, 256, 1e-5), (torch.bfloat16, 256, 1e-2),
                                         (torch.float32, 30, 1e-5), (torch.bfloat16, 12, 1e-2)])
def test_multiscale_roi_align_kernel_matches_twin(cuda, dtype, c, tol):
    """The multiscale forward kernel (vectorized and scalar channel paths)
    against the twin: every RoI on the twin's level, values within
    tol * max|F| (bf16: the output is rounded to bf16)."""
    rng = np.random.RandomState(c + 7)
    maps = [torch.from_numpy(rng.normal(size=(2,) + hw + (c,)).astype(np.float32)).to(dtype)
            for hw in FPN_HW]
    rois = torch.from_numpy(_fpn_rois(rng, 2, 96))
    before = _build.LAUNCH_COUNTS["roi_align_multiscale"]
    got = multiscale_roi_align_batched([m.to(cuda) for m in maps], rois.to(cuda), STRIDES)
    _out, levels = _multiscale_roi_align_cuda([m.to(cuda) for m in maps], rois.to(cuda), STRIDES,
                                              7, 2)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["roi_align_multiscale"] == before + 2
    want_levels = roi_levels(rois, 4)
    assert torch.equal(levels.cpu().long(), want_levels)
    assert set(want_levels.unique().tolist()) == {0, 1, 2, 3}
    want = multiscale_roi_align_batched_plain(maps, rois, STRIDES)
    assert got.dtype == dtype and got.shape == (2, 96, 7, 7, c)
    fmax = max(float(m.float().abs().max()) for m in maps)
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", [0, 3])
def test_multiscale_roi_align_kernel_on_one_level(cuda, dtype, level):
    """Every RoI on p2 (sides 16-110 px at aspects up to e^1.5: many span
    more distinct p2 columns than the ring holds two rows of) or every RoI
    on p5 (460-900 px): the levels and values of the twin."""
    rng = np.random.RandomState(31 + level)
    maps = [torch.from_numpy(rng.normal(size=(2,) + hw + (64,)).astype(np.float32)).to(dtype)
            for hw in FPN_HW]
    rois_np = (chip_smoke.p2_rois(rng, 2, 64, (128, 192)) if level == 0
               else _fpn_rois(rng, 2, 64, 460.0, 900.0))
    rois = torch.from_numpy(rois_np)
    out, levels = _multiscale_roi_align_cuda([m.to(cuda) for m in maps], rois.to(cuda), STRIDES,
                                             7, 2)
    torch.cuda.synchronize()
    assert bool((levels.cpu() == level).all())
    assert torch.equal(levels.cpu().long(), roi_levels(rois, 4))
    want = multiscale_roi_align_batched_plain(maps, rois, STRIDES)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    fmax = max(float(m.float().abs().max()) for m in maps)
    assert float((out.cpu().float() - want.float()).abs().max()) <= tol * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,p5", [(torch.float32, 256, False), (torch.bfloat16, 256, False),
                                        (torch.float32, 12, False), (torch.float32, 256, True)])
def test_multiscale_roi_align_backward_kernel_matches_twin(cuda, dtype, c, p5):
    """The maps' gradients of the CUDA path (the per-level tile gather)
    against the twin's autograd gradients, every element of each level
    within chip_smoke's sum-order limit; with p5 every RoI is large enough
    for the coarsest map, where the fewest tiles walk the most RoIs."""
    rng = np.random.RandomState(c + 11)
    maps = [torch.from_numpy(rng.normal(size=(2,) + hw + (c,)).astype(np.float32)).to(dtype)
            for hw in FPN_HW]
    rois = torch.from_numpy(_fpn_rois(rng, 2, 80, *((460.0, 900.0) if p5 else ())))
    g = torch.from_numpy(rng.normal(size=(2, 80, 7, 7, c)).astype(np.float32)).to(dtype)
    dev = [m.to(cuda).requires_grad_(True) for m in maps]
    r_dev = rois.to(cuda).requires_grad_(True)
    before = _build.LAUNCH_COUNTS["roi_align_multiscale_bwd"]
    multiscale_roi_align_batched(dev, r_dev, STRIDES).backward(g.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["roi_align_multiscale_bwd"] == before + 1
    assert r_dev.grad is None
    cpu = [m.clone().requires_grad_(True) for m in maps]
    multiscale_roi_align_batched_plain(cpu, rois, STRIDES).backward(g)
    limits = chip_smoke.sum_order_tolerance(
        lambda xs: multiscale_roi_align_batched_plain(xs, rois, STRIDES), maps, g, dtype)
    for level, (d, w, lim) in enumerate(zip(dev, cpu, limits)):
        assert d.grad.dtype == dtype
        assert chip_smoke.limit_ratio(d.grad.cpu(), w.grad, lim) <= 1.0, level
    if p5:
        assert float(cpu[3].grad.abs().max()) > 0 and float(cpu[0].grad.abs().max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,p,sr", [(torch.float32, 64, 7, 2), (torch.bfloat16, 64, 7, 2),
                                          (torch.float32, 30, 7, 2), (torch.bfloat16, 12, 7, 2),
                                          (torch.float32, 64, 7, 4), (torch.bfloat16, 64, 3, 1),
                                          (torch.bfloat16, 64, 5, 3)])
def test_roi_align_staged_forward_on_awkward_rois(cuda, dtype, c, p, sr):
    """The staged forward (4 channels a thread where C allows, else the
    scalar path: C 30 and 12) against the twin on CPU copies, on RoIs that
    straddle the map's edge, lie outside it, are under a cell or cover the
    whole 20 x 36 map (28 distinct tap columns: a ring of one row), at P x
    sr 7 x 2 (compiled in) and 3 x 1 to 7 x 4 (read at run time; 7 x 4:
    43 KB of staging in float32): within 1e-5 (float32) or 1e-2 (bf16) of
    max|F|.  P 8 raises."""
    rng = np.random.RandomState(c + p)
    feats = torch.from_numpy(rng.normal(size=(2, 20, 36, c)).astype(np.float32)).to(dtype)
    rois = _bwd_rois(rng, 2, 48, 20, 36)
    before = _build.LAUNCH_COUNTS["roi_align"]
    got = roi_align_batched(feats.to(cuda), rois.to(cuda), 1 / 16, p, sr)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["roi_align"] == before + 1
    want = roi_align_batched_plain(feats, rois, 1 / 16, p, sr)
    assert got.dtype == dtype and got.shape == (2, 48, p, p, c)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    fmax = float(feats.float().abs().max())
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol * fmax
    with pytest.raises(ValueError, match="at most 7"):
        roi_align_batched(feats.to(cuda), rois.to(cuda), 1 / 16, 8, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multiscale_roi_align_backward_is_bitwise_repeatable(cuda, dtype):
    """Two runs of the multiscale backward give the same gradients bit for
    bit (each cell sums its contributions in one fixed order)."""
    rng = np.random.RandomState(13)
    maps = [torch.from_numpy(rng.normal(size=(2,) + hw + (64,)).astype(np.float32)).to(dtype)
            for hw in FPN_HW]
    rois = torch.from_numpy(_fpn_rois(rng, 2, 96)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(2, 96, 7, 7, 64)).astype(np.float32)).to(dtype).to(cuda)
    runs = []
    for _ in range(2):
        dev = [m.to(cuda).requires_grad_(True) for m in maps]
        multiscale_roi_align_batched(dev, rois, STRIDES).backward(g)
        runs.append([d.grad.clone() for d in dev])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(float(a.float().abs().max()) > 0 for a in runs[0])


def _nan_like(t):
    return torch.full_like(t, float("nan"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [40, 0])
def test_roi_align_kernels_write_every_element(cuda, dtype, r):
    """The forward, backward and multiscale backward entries called on
    output buffers filled with NaN: every element is written (finite) and
    equals the wrapper's result; with R 0 both backwards are all zeros."""
    rng = np.random.RandomState(17 + r)
    lib, code = _build.library(), {torch.float32: 0, torch.bfloat16: 1}[dtype]
    stream = _build.stream_handle(cuda)
    feats = torch.from_numpy(rng.normal(size=(2, 20, 36, 64)).astype(np.float32)).to(dtype).to(cuda)
    rois = (_bwd_rois(rng, 2, r, 20, 36) if r else torch.zeros(2, 0, 4)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(2, r, 7, 7, 64)).astype(np.float32)).to(dtype).to(cuda)
    if r:
        out = _nan_like(roi_align_batched(feats, rois, 1 / 16))
        assert lib.frcnn_roi_align_fwd(feats.data_ptr(), rois.data_ptr(), out.data_ptr(), code, 1,
                                       2, 20, 36, 64, r, 1 / 16, 7, 2, 0, stream) == 0
        torch.cuda.synchronize()
        assert bool(out.isfinite().all())
        assert torch.equal(out, roi_align_batched(feats, rois, 1 / 16))
    grad = _nan_like(feats)
    scratch = torch.empty(lib.frcnn_roi_align_bwd_scratch_bytes(2, r, 1) + 1, dtype=torch.uint8,
                          device=cuda)
    assert lib.frcnn_roi_align_bwd(g.data_ptr(), rois.data_ptr(), grad.data_ptr(),
                                   scratch.data_ptr(), code, 2, 20, 36, 64, r, 1 / 16, 7, 2, 0,
                                   stream) == 0
    f = feats.clone().requires_grad_(True)
    roi_align_batched(f, rois, 1 / 16).backward(g)
    maps = [torch.from_numpy(rng.normal(size=(2,) + hw + (64,)).astype(np.float32)).to(dtype)
            .to(cuda) for hw in FPN_HW]
    fpn_np = _fpn_rois(rng, 2, r) if r else np.zeros((2, 0, 4), np.float32)
    fpn_rois = torch.from_numpy(fpn_np).to(cuda)
    grads = [_nan_like(m) for m in maps]
    ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in grads))
    heights = (ctypes.c_int * 4)(*(hw[0] for hw in FPN_HW))
    widths = (ctypes.c_int * 4)(*(hw[1] for hw in FPN_HW))
    scales = (ctypes.c_float * 4)(*(1.0 / s for s in STRIDES))
    scratch = torch.empty(lib.frcnn_roi_align_bwd_scratch_bytes(2, r, 4) + 1, dtype=torch.uint8,
                          device=cuda)
    assert lib.frcnn_roi_align_ms_bwd(
        g.data_ptr(), fpn_rois.data_ptr(), ctypes.addressof(ptrs), scratch.data_ptr(),
        ctypes.addressof(heights),
        ctypes.addressof(widths), ctypes.addressof(scales), code, 2, 64, r, 7, 2, stream) == 0
    dev = [m.clone().requires_grad_(True) for m in maps]
    multiscale_roi_align_batched(dev, fpn_rois, STRIDES).backward(g)
    torch.cuda.synchronize()
    assert bool(grad.isfinite().all()) and torch.equal(grad, f.grad)
    for got, d in zip(grads, dev):
        assert bool(got.isfinite().all()) and torch.equal(got, d.grad)
        assert r or not bool(got.any())
    assert r or not bool(grad.any())


@pytest.mark.cuda
def test_multiscale_roi_align_cuda_takes_only_the_detector_pyramid(cuda):
    """The kernels are built for p2..p5 with the LevelMapper's 224 at level
    4; any other pyramid raises on the card (the CPU twin takes 1-4 maps)."""
    rng = np.random.RandomState(5)
    maps = [torch.from_numpy(rng.normal(size=(1,) + hw + (8,)).astype(np.float32)).to(cuda)
            for hw in FPN_HW]
    rois = torch.from_numpy(_fpn_rois(rng, 1, 4)).to(cuda)
    before = _build.LAUNCH_COUNTS["roi_align_multiscale"]
    with pytest.raises(NotImplementedError, match="4 maps"):
        multiscale_roi_align_batched(maps[:3], rois, STRIDES[:3])
    with pytest.raises(NotImplementedError, match="224"):
        multiscale_roi_align_batched(maps, rois, STRIDES, canonical_scale=112)
    assert _build.LAUNCH_COUNTS["roi_align_multiscale"] == before
    out = multiscale_roi_align_batched([m.cpu() for m in maps[:3]], rois.cpu(), STRIDES[:3])
    assert out.shape == (1, 4, 7, 7, 8)


@pytest.mark.cuda
def test_rotated_iou_kernel_matches_twin(cuda):
    """The rotated IoU kernel within 5e-5 of the twin on clustered voxel-unit
    boxes and on the edge cases (identical 1, nested 0.25, shared edge 0,
    90 degrees 0.25, zero width 0, disjoint 0)."""
    rng = np.random.RandomState(7)
    boxes = torch.from_numpy(chip_smoke.rotated_boxes(rng, 3, 150))
    others = torch.from_numpy(chip_smoke.rotated_boxes(rng, 3, 70))
    before = _build.LAUNCH_COUNTS["rotated_iou"]
    got = rotated_iou_matrix(boxes.to(cuda), others.to(cuda)).cpu()
    assert _build.LAUNCH_COUNTS["rotated_iou"] == before + 1
    want = rotated_iou_matrix_plain(boxes, others)
    assert got.shape == (3, 150, 70) and float((got - want).abs().max()) <= 5e-5
    e = torch.from_numpy(chip_smoke.ROTATED_EDGE_CASES)
    ge = rotated_iou_matrix(e.to(cuda), e.to(cuda)).cpu()
    assert float((ge - rotated_iou_matrix_plain(e, e)).abs().max()) <= 5e-5
    assert abs(float(ge[0, 1]) - 1) <= 1e-6 and abs(float(ge[0, 2]) - 0.25) <= 1e-6
    assert abs(float(ge[3, 8])) <= 1e-6 and abs(float(ge[4, 8]) - 0.25) <= 1e-6
    assert float(ge[5].abs().max()) <= 1e-6 and float(ge[6, :6].max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,thr,max_out", [(16, 300, 0.3, 100), (4, 130, 0.6, 50)])
def test_rotated_nms_kernel_matches_twin(cuda, g, n, thr, max_out):
    """Rotated NMS keeps: the tolerant greedy check against the twin's IoU on
    every problem, identical to the twin's keeps where no kept lane's pair
    lies within 1e-4 of the threshold."""
    rng = np.random.RandomState(n)
    boxes = chip_smoke.rotated_boxes(rng, g, n)
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    scores[0] = np.round(scores[0] * 4) / 4  # ties
    valid = rng.uniform(size=(g, n)) < 0.8
    tb, ts, tv = (torch.from_numpy(a) for a in (boxes, scores, valid))
    before = _build.LAUNCH_COUNTS["nms_rotated"]
    idx, ok = nms(tb.to(cuda), ts.to(cuda), thr, max_out, tv.to(cuda), rotated=True)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["nms_rotated"] == before + 1
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    want_idx, want_ok = (t.numpy() for t in nms_plain(tb, ts, thr, max_out, tv, rotated=True))
    iou = rotated_iou_matrix_plain(tb, tb).numpy()
    for i in range(g):
        assert chip_smoke.greedy_violations(iou[i], scores[i], valid[i], idx[i], ok[i], thr, 1e-4,
                                            max_out) == [], i
        if not chip_smoke.near_threshold(iou[i], valid[i], thr, 1e-4, want_idx[i][want_ok[i]]):
            assert np.array_equal(idx[i], want_idx[i]) and np.array_equal(ok[i], want_ok[i]), i


@pytest.mark.cuda
def test_rotated_nms_rejects_bad_inputs_on_the_card(cuda):
    """float32 boxes of 5 values on one device, or it raises; it never runs
    the twin on the card."""
    boxes, scores = torch.zeros(2, 8, 5, device=cuda), torch.zeros(2, 8, device=cuda)
    with pytest.raises(TypeError):
        nms(boxes.double(), scores.double(), 0.3, 4, rotated=True)
    with pytest.raises(ValueError):
        nms(boxes, scores.cpu(), 0.3, 4, rotated=True)
    with pytest.raises(ValueError):
        nms(boxes[..., :4], scores, 0.3, 4, rotated=True)
