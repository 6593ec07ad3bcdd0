"""Port ops vs the JAX package: anchors, box transforms, NMS, RoI align and
the final filter.  Inputs come from numpy RandomState seeds and go through
both the JAX function (on the CPU) and the port's counterpart (its plain
twin on CPU tensors)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.ops import anchors as j_anchors  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import box_transform as j_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.filter import (  # noqa: E402
    clamp_image_boxes as j_clamp,
    filter_detections as j_filter,
    to_per_class_lists as j_lists,
)
from faster_rcnn_pytorch_multimodal_tpu.ops.nms import nms as j_nms  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.roi_align import (  # noqa: E402
    roi_align_batched as j_roi_align_batched,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import box_transform as t_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (  # noqa: E402
    clamp_image_boxes as t_clamp,
    filter_detections as t_filter,
    to_per_class_lists as t_lists,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms as t_nms  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (  # noqa: E402
    roi_align as t_roi_align,
    roi_align_batched as t_roi_align_batched,
)


def _boxes(rng, n, extent=400.0, size=(5.0, 120.0)):
    x1 = rng.uniform(0, extent, n)
    y1 = rng.uniform(0, extent, n)
    w = rng.uniform(*size, n)
    h = rng.uniform(*size, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


# -- anchors: exact --------------------------------------------------------


@pytest.mark.parametrize(
    "h,w,scales,ratios,frame_scale",
    [
        (32, 60, (2.0, 4.0, 8.0, 16.0, 32.0), (0.5, 0.75, 1.0, 1.25, 2.0), 1.0),
        (7, 11, (8, 16, 32), (0.5, 1, 2), 0.5),
    ],
)
def test_anchors_exact(h, w, scales, ratios, frame_scale):
    want, n_want = j_anchors.generate_anchors_pre(h, w, 16, scales, ratios, frame_scale)
    got, n_got = t_anchors.generate_anchors_pre(h, w, 16, scales, ratios, frame_scale)
    assert n_got == n_want == h * w * len(scales) * len(ratios)
    np.testing.assert_array_equal(got, want)


# -- box transforms: rtol 1e-6 (same float32 formula; exp/sqrt may differ
# by an ulp between XLA's and PyTorch's CPU kernels) -----------------------


def test_bbox_transform_and_inverse():
    rng = np.random.RandomState(0)
    ex = _boxes(rng, 200).reshape(2, 100, 4)
    gt = _boxes(rng, 200).reshape(2, 100, 4)
    deltas = rng.normal(0, 0.3, (2, 100, 12)).astype(np.float32)
    np.testing.assert_allclose(
        t_bt.bbox_transform(torch.from_numpy(ex), torch.from_numpy(gt)).numpy(),
        np.asarray(j_bt.bbox_transform(jnp.asarray(ex), jnp.asarray(gt))),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        t_bt.bbox_transform_inv(torch.from_numpy(ex), torch.from_numpy(deltas)).numpy(),
        np.asarray(j_bt.bbox_transform_inv(jnp.asarray(ex), jnp.asarray(deltas))),
        rtol=1e-6, atol=1e-4,
    )


def test_clip_boxes_single_and_batched_window():
    rng = np.random.RandomState(1)
    boxes = rng.uniform(-50, 500, (3, 40, 8)).astype(np.float32)
    windows = np.array([[0, 320, 0, 256], [10, 300, 5, 200], [0, 480, 0, 480]], np.float32)
    got = t_bt.clip_boxes(torch.from_numpy(boxes), torch.from_numpy(windows)).numpy()
    for i in range(3):
        want = np.asarray(j_bt.clip_boxes(jnp.asarray(boxes[i]), jnp.asarray(windows[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-6)
        one = t_bt.clip_boxes(torch.from_numpy(boxes[i]), torch.from_numpy(windows[i]))
        np.testing.assert_allclose(one.numpy(), want, rtol=1e-6)


# -- NMS: index-exact keeps against JAX's default and exact=True ----------


def _nms_case(name):
    rng = np.random.RandomState(NMS_CASES.index(name))
    if name.startswith("random"):
        n = int(name.split("_")[1])
        return _boxes(rng, n), rng.uniform(size=n).astype(np.float32), None, 0.6, min(n, 300)
    if name == "ties":
        n = 256
        return _boxes(rng, n), rng.randint(0, 6, n).astype(np.float32) / 5, None, 0.5, 256
    if name == "invalid":
        n = 300
        valid = rng.uniform(size=n) < 0.6
        return _boxes(rng, n), rng.uniform(size=n).astype(np.float32), valid, 0.5, 100
    if name == "degenerate":
        n = 128
        b = _boxes(rng, n, extent=60.0)
        b[::3, 2] = b[::3, 0]  # zero width
        b[1::5, 3] = b[1::5, 1]  # zero height
        b[2::7] = b[0]  # duplicates of a zero-area box
        return b, rng.uniform(size=n).astype(np.float32), None, 0.3, n
    if name == "truncate":
        n = 400
        return _boxes(rng, n, size=(40.0, 200.0)), rng.uniform(size=n).astype(np.float32), None, 0.7, 10
    if name == "chain":
        # consecutive boxes overlap above threshold, every other one below:
        # greedy keeps the even lanes (tests/test_iou_nms.py:83-95)
        n = 20
        b = np.array([[i * 3.0, 0, i * 3.0 + 10, 10] for i in range(n)], np.float32)
        return b, np.linspace(1, 0.5, n).astype(np.float32), None, 0.5, n
    raise KeyError(name)


NMS_CASES = [
    "random_64", "random_512", "random_2048", "ties", "invalid", "degenerate",
    "truncate", "chain",
]


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_twin_matches_jax(name):
    boxes, scores, valid, thr, max_out = _nms_case(name)
    tv = None if valid is None else torch.from_numpy(valid)
    got_idx, got_ok = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out, tv)
    jv = None if valid is None else jnp.asarray(valid)
    for exact in (False, True):
        want_idx, want_ok = j_nms(
            jnp.asarray(boxes), jnp.asarray(scores), thr, max_out, valid=jv, exact=exact
        )
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    if name == "chain":
        np.testing.assert_array_equal(got_idx.numpy()[got_ok.numpy()], np.arange(0, 20, 2))
    assert got_idx.dtype == torch.int32 and got_ok.dtype == torch.bool
    assert _build.LAUNCH_COUNTS["nms"] == 0  # CPU tensors never launch


def test_nms_batched_matches_per_problem_loop():
    rng = np.random.RandomState(7)
    g, n = 6, 200
    boxes = _boxes(rng, g * n).reshape(2, 3, n, 4)
    scores = rng.uniform(size=(2, 3, n)).astype(np.float32)
    valid = rng.uniform(size=(2, 3, n)) < 0.8
    idx, ok = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 50,
                    torch.from_numpy(valid))
    assert idx.shape == ok.shape == (2, 3, 50)
    for a in range(2):
        for b in range(3):
            i1, o1 = t_nms(torch.from_numpy(boxes[a, b]), torch.from_numpy(scores[a, b]),
                           0.5, 50, torch.from_numpy(valid[a, b]))
            np.testing.assert_array_equal(idx[a, b].numpy(), i1.numpy())
            np.testing.assert_array_equal(ok[a, b].numpy(), o1.numpy())


# -- RoI align: max abs err <= 1e-5 * max|F| (JAX pre-averages its weights
# and sums in another order; same float32 formula) --------------------------


def _rois(rng, r, h, w, stride=16.0):
    ext_h, ext_w = h * stride, w * stride
    inside = _boxes(rng, r, extent=min(ext_h, ext_w) * 0.6, size=(8.0, min(ext_h, ext_w) * 0.3))
    straddle = inside.copy()
    straddle[:, [0, 1]] -= 0.5 * min(ext_h, ext_w)
    straddle[:, [2, 3]] += 0.3 * max(ext_h, ext_w)
    outside = inside + np.float32(3 * max(ext_h, ext_w))
    tiny = inside.copy()
    tiny[:, 2:] = tiny[:, :2] + rng.uniform(0.5, 10.0, (r, 2)).astype(np.float32)
    return np.concatenate([inside, straddle, outside, tiny]).astype(np.float32)


@pytest.mark.parametrize("hw", [(12, 20), (20, 12)], ids=["w_ge_h", "w_lt_h"])
def test_roi_align_twin_matches_jax(hw):
    rng = np.random.RandomState(3)
    h, w = hw
    feats = rng.normal(size=(2, h, w, 16)).astype(np.float32)
    rois = np.stack([_rois(rng, 6, h, w), _rois(rng, 6, h, w)])
    want = np.asarray(j_roi_align_batched(jnp.asarray(feats), jnp.asarray(rois), 1 / 16.0))
    got = t_roi_align_batched(torch.from_numpy(feats), torch.from_numpy(rois), 1 / 16.0)
    assert got.shape == want.shape == (2, 24, 7, 7, 16)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(feats).max()
    one = t_roi_align(torch.from_numpy(feats[1]), torch.from_numpy(rois[1]), 1 / 16.0)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())
    assert _build.LAUNCH_COUNTS["roi_align"] == 0


def test_roi_align_twin_aligned_and_sampling_ratio():
    rng = np.random.RandomState(4)
    feats = rng.normal(size=(1, 10, 14, 8)).astype(np.float32)
    rois = _rois(rng, 4, 10, 14)[None]
    for kw in (dict(aligned=True), dict(sampling_ratio=3, output_size=5)):
        want = np.asarray(j_roi_align_batched(jnp.asarray(feats), jnp.asarray(rois), 1 / 16.0, **kw))
        got = t_roi_align_batched(torch.from_numpy(feats), torch.from_numpy(rois), 1 / 16.0, **kw)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(feats).max()


# -- final filter: equal kept sets and boxes -------------------------------


def test_filter_detections_matches_jax():
    rng = np.random.RandomState(5)
    b, s, k = 2, 300, 3
    logits = rng.normal(0, 1.5, (b, s, k)).astype(np.float32)
    cls_prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    boxes = np.concatenate([_boxes(rng, b * s, size=(20.0, 80.0)).reshape(b, s, 1, 4)] * k, 2)
    boxes += rng.normal(0, 6, boxes.shape).astype(np.float32)
    boxes = boxes.reshape(b, s, k * 4).astype(np.float32)
    roi_valid = rng.uniform(size=(b, s)) < 0.9
    kw = dict(num_classes=k, bbox_elem=4, max_dets=100, thresh=0.4, nms_thresh=0.6)
    got = t_filter(torch.from_numpy(cls_prob), torch.from_numpy(boxes),
                   torch.from_numpy(roi_valid), **kw)
    for i in range(b):
        want = j_filter(jnp.asarray(cls_prob[i]), jnp.asarray(boxes[i]),
                        jnp.asarray(roi_valid[i]), **kw)
        for key in ("valid", "src_idx", "boxes", "scores"):
            np.testing.assert_array_equal(got[key][i].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["valid"][:, 0].sum() == 0  # background never kept
    assert got["valid"][:, 1:].sum() > 20


def test_clamp_image_boxes_and_per_class_lists_match_jax():
    rng = np.random.RandomState(6)
    boxes = rng.uniform(-40, 700, (50, 12)).astype(np.float32)
    info = np.array([0, 640, 0, 480, 0, 0, 0.5], np.float32)
    np.testing.assert_array_equal(
        t_clamp(torch.from_numpy(boxes), torch.from_numpy(info)).numpy(),
        np.asarray(j_clamp(jnp.asarray(boxes), jnp.asarray(info))),
    )
    k, m, s = 3, 10, 50
    filtered = {
        "boxes": rng.uniform(0, 100, (k, m, 4)).astype(np.float32),
        "scores": rng.uniform(size=(k, m)).astype(np.float32),
        "valid": rng.uniform(size=(k, m)) < 0.6,
        "src_idx": rng.randint(0, s, (k, m)),
    }
    uc = {"a_entropy": rng.uniform(size=s), "a_bbox_var": rng.uniform(size=(s, k * 4))}
    got_boxes, got_uc = t_lists(filtered, uc, k, 4)
    want_boxes, want_uc = j_lists(filtered, uc, k, 4)
    for j in range(k):
        np.testing.assert_array_equal(got_boxes[j], want_boxes[j])
        assert got_uc[j].keys() == want_uc[j].keys()
        for key in got_uc[j]:
            np.testing.assert_array_equal(got_uc[j][key], want_uc[j][key])
