"""Rotated BEV IoU and rotated NMS (TEST.ROTATED_NMS), port vs the JAX
package, on the CPU.

The port's twin (ops/rotated_iou.py) runs the JAX candidate-vertex
formulation op for op, on each pair taken relative to its row box's center.
Both are held against the float64 Sutherland-Hodgman oracle of the port's
evaluation/eval_utils.py.  The JAX function takes its shoelace over absolute
coordinates, whose cross products cancel as the coordinates grow: on the
inputs below (the tests print each maximum) it sits 4.7e-6 off the oracle
at metre scale and 3.1e-6 on a 100-voxel patch, but 3.2e-4 across the
0-400 voxel raster, where the twin stays 3.6e-7 off.  So on the raster the
twin is held to 2e-5 of JAX run on the same row-centered pairs, and to JAX
on absolute coordinates only within JAX's own error there.  Rotated NMS
keeps are compared with JAX `nms(rotated=True, exact=True)` where no pair's
IoU lies within 1e-4 of the threshold, and on every problem by the tolerant
greedy check that chip_smoke.py applies to the kernel.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.ops.filter import (  # noqa: E402
    filter_detections as j_filter,
)
from faster_rcnn_pytorch_multimodal_tpu.ops.nms import nms as j_nms  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.rotated_iou import (  # noqa: E402
    rotated_iou_matrix as j_riou,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (  # noqa: E402
    rotated_bev_intersection,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (  # noqa: E402
    filter_detections as t_filter,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, pairwise_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (  # noqa: E402
    rotated_iou_matrix,
    rotated_iou_matrix_plain,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

NEAR = 1e-4  # a pair this close to the threshold may fall either way
# (centers, l, w, cluster jitter): metre scale (the JAX test's), a 100-voxel
# patch, and the whole 400 x 350 raster at 0.2 m voxels
SCALES = {
    "metre": ((-40.0, 40.0), (1.0, 8.0), (1.0, 4.0), 2.0),
    "voxel": ((0.0, 100.0), (8.0, 25.0), (4.0, 10.0), 6.0),
    "raster": ((0.0, 400.0), (8.0, 25.0), (4.0, 10.0), 6.0),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, scale, clustered=0):
    """(n, 5) [xc, yc, l, w, ry]; the first `clustered` boxes jittered copies
    of the last ones' centers, so that many pairs overlap."""
    (c0, c1), ls, ws, jit = SCALES[scale]
    b = np.stack([rng.uniform(c0, c1, n), rng.uniform(c0, c1, n), rng.uniform(*ls, n),
                  rng.uniform(*ws, n), rng.uniform(-np.pi, np.pi, n)], 1)
    if clustered:
        b[:clustered, :2] = b[-clustered:, :2] + rng.uniform(-jit, jit, (clustered, 2))
    return b.astype(np.float32)


def _oracle(a, b):
    """float64 Sutherland-Hodgman IoU of every pair (eval_utils)."""
    out = np.zeros((len(a), len(b)))
    for i, p in enumerate(a.astype(np.float64)):
        for j, q in enumerate(b.astype(np.float64)):
            a7 = np.array([p[0], p[1], 0.0, p[2], p[3], 1.0, p[4]])
            b7 = np.array([q[0], q[1], 0.0, q[2], q[3], 1.0, q[4]])
            inter = rotated_bev_intersection(a7, b7)
            union = p[2] * p[3] + q[2] * q[3] - inter
            out[i, j] = inter / union if union > 1e-9 else 0.0
    return out


@pytest.mark.parametrize("scale", ["metre", "voxel"])
def test_rotated_iou_matches_jax_and_oracle(scale):
    rng = np.random.default_rng(0 if scale == "metre" else 1)
    a = _boxes(rng, 60, scale)
    b = _boxes(rng, 60, scale)
    b[:30, :2] = a[:30, :2] + rng.uniform(-1, 1, (30, 2)) * SCALES[scale][3]
    got = rotated_iou_matrix(_t(a), _t(b)).numpy()
    want = np.asarray(j_riou(jnp.asarray(a), jnp.asarray(b)))
    oracle = _oracle(a, b)
    print(f"{scale}, 60 x 60 pairs: max |twin - JAX| {np.abs(got - want).max()}, |twin - oracle| "
          f"{np.abs(got - oracle).max()}, |JAX - oracle| {np.abs(want - oracle).max()}")
    assert got.dtype == np.float32 and got.shape == (60, 60)
    assert np.abs(got - want).max() <= 2e-5
    assert np.abs(got - oracle).max() <= 5e-5
    assert np.abs(want - oracle).max() <= 5e-5
    assert (oracle > 0.05).sum() > 20  # overlaps were compared


def test_rotated_iou_across_the_raster():
    """Centers over 0-400 voxels, 80 boxes (40 clustered), seed 2: the twin
    within 5e-5 of the oracle, and within 2e-5 of JAX on the same pairs
    taken relative to the row box's center, as the twin takes them.  JAX on
    the absolute coordinates is 3.2e-4 off the oracle on these pairs, so the
    twin and it agree only to that: 5e-4, 1.6x this input's reading."""
    rng = np.random.default_rng(2)
    a = _boxes(rng, 80, "raster", clustered=40)
    got = rotated_iou_matrix(_t(a), _t(a)).numpy()
    oracle = _oracle(a, a)
    want = np.asarray(j_riou(jnp.asarray(a), jnp.asarray(a)))
    rows = []
    for i in range(len(a)):
        rel = a.copy()
        rel[:, :2] -= a[i, :2]
        rows.append(np.asarray(j_riou(jnp.asarray(rel[i:i + 1]), jnp.asarray(rel)))[0])
    centered = np.stack(rows)
    print(f"raster, 80 x 80 pairs: max |twin - oracle| {np.abs(got - oracle).max()}, |twin - "
          f"JAX row-centered| {np.abs(got - centered).max()}, |JAX - oracle| "
          f"{np.abs(want - oracle).max()}, |twin - JAX| {np.abs(got - want).max()}")
    assert np.abs(got - oracle).max() <= 5e-5
    assert np.abs(got - centered).max() <= 2e-5
    assert np.abs(got - want).max() <= 5e-4
    assert np.abs(got - oracle).max() < np.abs(want - oracle).max()
    assert (oracle > 0.05).sum() > 100


def test_rotated_iou_batched_and_chunked(monkeypatch):
    """(G, N, 5) x (G, M, 5) equals the per-problem matrices, whatever the
    row chunk."""
    rng = np.random.default_rng(3)
    a = np.stack([_boxes(rng, 23, "voxel", clustered=10) for _ in range(3)])
    b = np.stack([_boxes(rng, 17, "voxel", clustered=8) for _ in range(3)])
    whole = rotated_iou_matrix_plain(_t(a), _t(b))
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import rotated_iou

    monkeypatch.setattr(rotated_iou, "_CHUNK_PAIRS", 40)
    chunked = rotated_iou_matrix_plain(_t(a), _t(b))
    assert whole.shape == (3, 23, 17)
    assert torch.equal(whole, chunked)
    for g in range(3):
        assert torch.equal(whole[g], rotated_iou_matrix_plain(_t(a[g]), _t(b[g])))


def test_rotated_iou_axis_aligned_equals_aabb():
    rng = np.random.default_rng(4)
    a = _boxes(rng, 16, "metre")
    a[:, 0:2] = rng.uniform(-6, 6, (16, 2))
    a[:, 4] = 0.0
    corners = np.stack([a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2,
                        a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2], 1)
    got = rotated_iou_matrix(_t(a), _t(a)).numpy()
    want = pairwise_iou(_t(corners)[None], _t(corners)[None])[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-6)
    assert (want > 0.05).sum() > 16


def test_rotated_iou_edge_cases():
    """Identical boxes (1), a box inside another (area ratio), a shared edge
    and disjoint boxes (0), a 90-degree turn, zero-width boxes (0)."""
    e = np.array([
        [10, 10, 20, 8, 0.3],
        [10, 10, 20, 8, 0.3],  # identical
        [10, 10, 10, 4, 0.3],  # inside 0 at a quarter of its area
        [10, 18, 20, 8, 0.0],  # shares an edge with 8
        [10, 10, 20, 8, np.pi / 2],  # 8 turned by 90 degrees
        [10, 10, 20, 0, 0.1],  # zero width
        [60, 60, 10, 5, 1.0],  # disjoint from all
        [40, 10, 20, 8, 0.0],  # disjoint from 8, shares no edge
        [10, 10, 20, 8, 0.0],
    ], np.float32)
    got = rotated_iou_matrix(_t(e), _t(e)).numpy()
    want = np.asarray(j_riou(jnp.asarray(e), jnp.asarray(e)))
    oracle = _oracle(e, e)
    np.testing.assert_allclose(got, oracle, atol=5e-5)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert abs(got[0, 1] - 1.0) <= 1e-6 and abs(got[0, 2] - 0.25) <= 1e-6
    assert got[3, 8] == 0.0 and got[7, 8] == 0.0 and abs(got[6].sum() - 1.0) <= 1e-6
    assert abs(got[4, 8] - 64 / (320 - 64)) <= 1e-6
    assert np.abs(got[5]).max() <= 1e-6 and np.abs(got[:, 5]).max() <= 1e-6


def test_rotated_nms_catches_heading_offset_duplicate():
    """The duplicate the rotation-ignoring AABB NMS keeps (the JAX test's
    case): rotated IoU ~0.68, the footprints' AABB IoU ~0.35."""
    t = np.pi / 4
    dup = np.array([[0.0, 0.0, 6.0, 2.0, t], [0.8, 0.8, 6.0, 2.0, t]], np.float32)
    riou = rotated_iou_matrix(_t(dup), _t(dup)).numpy()
    assert riou[0, 1] > 0.6
    aabb = np.stack([dup[:, 0] - 3, dup[:, 1] - 1, dup[:, 0] + 3, dup[:, 1] + 1], 1)
    scores = _t(np.array([0.9, 0.8], np.float32))
    _, v_rot = nms(_t(dup), scores, 0.6, 2, rotated=True)
    _, v_aabb = nms(_t(aabb), scores, 0.6, 2)
    assert int(v_rot.sum()) == 1 and int(v_aabb.sum()) == 2


def _jax_keeps(boxes, scores, valid, thr, max_out):
    idx, ok = j_nms(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out,
                    valid=jnp.asarray(valid), rotated=True, exact=True)
    return np.asarray(idx), np.asarray(ok)


@pytest.mark.parametrize("n,thr,max_out,scale,spread", [(80, 0.3, 40, "metre", 4),
                                                        (160, 0.6, 100, "voxel", 4),
                                                        (300, 0.3, 100, "voxel", 1.5)])
def test_rotated_nms_keeps_equal_jax(n, thr, max_out, scale, spread):
    """Dense problems: identical keeps where no pair lies within 1e-4 of the
    threshold; on every problem the tolerant greedy check against JAX's IoU
    matrix passes; the CPU path launches nothing."""
    rng = np.random.default_rng(n)
    g = 4
    boxes = np.stack([_boxes(rng, n, scale, clustered=n // 2) for _ in range(g)])
    boxes[..., :2] = (boxes[..., :2] - boxes[..., :2].min()) / spread  # dense: chains
    scores = rng.uniform(0.1, 1.0, (g, n)).astype(np.float32)
    scores[0] = np.round(scores[0] * 8) / 8  # ties
    valid = rng.uniform(size=(g, n)) < 0.9
    before = dict(_build.LAUNCH_COUNTS)
    idx, ok = (a.numpy() for a in nms(_t(boxes), _t(scores), thr, max_out, _t(valid),
                                      rotated=True))
    assert _build.LAUNCH_COUNTS == before
    identical = 0
    for i in range(g):
        iou = np.asarray(j_riou(jnp.asarray(boxes[i]), jnp.asarray(boxes[i])))
        want_idx, want_ok = _jax_keeps(boxes[i], scores[i], valid[i], thr, max_out)
        assert chip_smoke.greedy_violations(iou, scores[i], valid[i], idx[i], ok[i], thr, NEAR,
                                            max_out) == []
        if not chip_smoke.near_threshold(iou, valid[i], thr, NEAR, want_idx[want_ok]):
            np.testing.assert_array_equal(ok[i], want_ok)
            np.testing.assert_array_equal(idx[i], want_idx)
            identical += 1
        assert ok[i].sum() > 1
    print(f"{identical} of {g} problems without a kept lane's pair within {NEAR} of {thr}")
    assert identical >= g // 2


def test_greedy_check_catches_a_wrong_keep():
    """The tolerant greedy check fails a keep set with a lane added, dropped
    or out of order."""
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 60, "metre", clustered=30)
    boxes[:, :2] /= 8
    scores = rng.uniform(size=60).astype(np.float32)
    valid = np.ones(60, bool)
    iou = rotated_iou_matrix(_t(boxes), _t(boxes)).numpy()
    idx, ok = (a.numpy() for a in nms(_t(boxes), _t(scores), 0.3, 60, _t(valid), rotated=True))
    check = chip_smoke.greedy_violations
    assert check(iou, scores, valid, idx, ok, 0.3, NEAR, 60) == []
    k = int(ok.sum())
    assert 2 < k < 60
    rank = np.argsort(chip_smoke.score_order(scores, valid))
    dropped = np.setdiff1d(np.arange(60), idx[:k])[0]
    lanes = sorted([*idx[:k], dropped], key=lambda lane: rank[lane])
    added = np.array(lanes + [0] * (59 - k)), np.arange(60) <= k
    assert check(iou, scores, valid, *added, 0.3, NEAR, 60)
    short = idx.copy(), ok.copy()
    short[1][k - 1] = False
    assert check(iou, scores, valid, *short, 0.3, NEAR, 60)
    swapped = idx.copy()
    swapped[[0, 1]] = swapped[[1, 0]]
    assert check(iou, scores, valid, swapped, ok, 0.3, NEAR, 60)


def test_filter_detections_rotated_equals_jax():
    """The rotated filter on (B, S, 7K) boxes: one batched rotated NMS over
    (frame, class) against JAX's per-frame filter."""
    rng = np.random.default_rng(6)
    b, s, k = 2, 200, 3
    cls_prob = rng.dirichlet([1.0] * k, (b, s)).astype(np.float32)
    boxes = np.stack([rng.uniform(0, 40, (b, s)), rng.uniform(0, 40, (b, s)),
                      rng.uniform(0, 2, (b, s)), rng.uniform(8, 25, (b, s)),
                      rng.uniform(4, 10, (b, s)), rng.uniform(1, 2, (b, s)),
                      rng.uniform(-3, 3, (b, s))], -1)
    pred = np.concatenate([boxes, boxes + 1.0, boxes * 0.9], -1).astype(np.float32)
    roi_valid = rng.uniform(size=(b, s)) < 0.9
    kw = dict(num_classes=k, bbox_elem=7, max_dets=100, thresh=0.2, nms_thresh=0.3,
              is_lidar=True, rotated_nms=True)
    got = t_filter(_t(cls_prob), _t(pred), _t(roi_valid), **kw)
    kept = 0
    for i in range(b):
        want = j_filter(jnp.asarray(cls_prob[i]), jnp.asarray(pred[i]), jnp.asarray(roi_valid[i]),
                        **kw)
        for key in ("valid", "src_idx", "boxes", "scores"):
            np.testing.assert_array_equal(got[key][i].numpy(), np.asarray(want[key]), err_msg=key)
        kept += int(np.asarray(want["valid"]).sum())
    aabb = t_filter(_t(cls_prob), _t(pred), _t(roi_valid), **{**kw, "rotated_nms": False})
    assert kept > 0 and not torch.equal(aabb["valid"], got["valid"])


def test_rotated_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        nms(torch.zeros(5, 4), torch.zeros(5), 0.5, 3, rotated=True)  # 4 values a box
    with pytest.raises(ValueError):
        rotated_iou_matrix(torch.zeros(2, 5, 5), torch.zeros(3, 4, 5))  # leading dims
    with pytest.raises(ValueError):
        rotated_iou_matrix(torch.zeros(5, 4), torch.zeros(4, 5))
    with pytest.raises(TypeError):
        rotated_iou_matrix(torch.zeros(5, 5).double(), torch.zeros(4, 5).double())


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1]
                                                  / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_cli_with_rotated_nms(tmp_path, monkeypatch):
    """tools/test_net_torch.py serves LiDAR frames with --set TEST.ROTATED_NMS
    True TEST.NMS_THRESH 0.3: the final filter's NMS runs on the rotated
    footprints at 0.3, the proposals' on axis-aligned boxes."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import filter as t_filter_mod

    calls = []

    def spy(boxes, scores, thr, max_out, valid=None, rotated=False):
        calls.append((boxes.shape[-1], thr, rotated))
        return nms(boxes, scores, thr, max_out, valid, rotated)

    monkeypatch.setattr(t_filter_mod, "nms", spy)
    m_ap = _tool("test_net_torch").main([
        "--device", "cpu", "--net", "res50", "--net_type", "lidar", "--scale", "0.25",
        "--max_frames", "2", "--batch_size", "2", "--out_dir", str(tmp_path),
        "--set", "COMPUTE_DTYPE", "float32", "STATIC.NMS_PRE_TEST", "256",
        "TEST.RPN_POST_NMS_TOP_N", "32", "STATIC.MAX_POINTS", "8192",
        "TEST.ROTATED_NMS", "True", "TEST.NMS_THRESH", "0.3"])
    assert np.isfinite(m_ap)
    assert calls and all(c == (5, 0.3, True) for c in calls)
