"""The whole serving slice, port vs the JAX package, at res50 on 128x192
frames (the same Bottleneck code as res101, cheaper to trace on the CPU).

Both detectors share one set of weights: the flax FasterRCNN is initialized,
its BN statistics randomized from a numpy seed and the residual terminators
scaled to 0.25 (as bench.py does).  That keeps the activations bounded, so
with the heads at their init scale the anchor and class scores are distinct
floats (checked below) instead of saturated ties.  The port loads the
weights through the weight bridge.  Everything runs in float32 on the CPU,
the port through its plain twins.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import (  # noqa: E402
    cfg_from_list,
    default_config,
)
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.filter import (  # noqa: E402
    filter_detections as j_filter,
)
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (  # noqa: E402
    filter_detections as t_filter,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    from_flax_variables,
    load_flax_variables,
    to_flax_variables,
)

B, H, W, K = 2, 128, 192, 2
PRE_N, POST_N = 256, 32


OVERRIDES = (
    "NET_TYPE", "image",
    "NET_VARIANT", "res50",
    "COMPUTE_DTYPE", "float32",
    "PIXEL_STDDEVS", "[60.,60.,60.]",
    "TEST.SCALES", "(1.0,)",
    "STATIC.NMS_PRE_TEST", str(PRE_N),
    "TEST.RPN_POST_NMS_TOP_N", str(POST_N),
)


def _cfg():
    """The JAX package's config."""
    return cfg_from_list(default_config(), OVERRIDES)


def _tcfg():
    """The port's config, from the same overrides."""
    return t_config.cfg_from_list(t_config.default_config(), OVERRIDES)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _shared_variables(model, x, window):
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(window))
    rng = np.random.RandomState(0)
    params = {}
    for path, v in _flat(variables["params"]):
        v = np.array(v, np.float32)
        if path[-1] == "mean":
            v = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif path[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path[-2:] == ("bn3", "scale"):
            v = np.full_like(v, 0.25)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return {"params": params}


@pytest.fixture(scope="module")
def slice_run():
    return _run_both()


def _run_both():
    cfg = _cfg()
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    j_model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    variables = _shared_variables(j_model, x, window)

    def _stages(m, images, win):
        feats = m.features(images, deterministic=True)
        rpn = m.rpn_scores(feats["rpn"])
        rpn["anchors"] = m._anchors(feats["rpn"], phase="test")
        props = m._propose_batch(rpn, win, "test")
        return feats["rpn"], rpn, props

    j_feat, j_rpn, j_props = j_model.apply(
        variables, jnp.asarray(x), jnp.asarray(window), method=_stages)
    j_out = j_model.apply(
        variables, jnp.asarray(x), jnp.asarray(window),
        method=j_det.FasterRCNN.forward_test, rngs={"dropout": jax.random.PRNGKey(0)})

    tcfg = _tcfg()
    t_model = t_det.FasterRCNN(tcfg, K)
    load_flax_variables(t_model, variables)
    t_model.eval()
    return types.SimpleNamespace(
        cfg=cfg, tcfg=tcfg, x=x, window=window, variables=variables, t_model=t_model,
        j_feat=np.asarray(j_feat),
        j_fg=np.asarray(j_rpn["fg_prob"]), j_deltas=np.asarray(j_rpn["deltas"]),
        j_props=[np.asarray(a) for a in j_props],
        j_out={k: np.asarray(v) for k, v in j_out.items() if k in
               ("rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred")},
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _iou_plus1(a, b):
    """Pairwise IoU with +1 areas (the reference's bbox_overlaps), so that
    proposals clipped to a point on the window edge still match themselves."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _split_thresh(cls_prob):
    """A score threshold halfway between the two middle class-1 scores, so
    half the rois pass and no score sits within backend noise of it."""
    s = np.sort(cls_prob[..., 1].ravel())
    i = s.size // 2
    assert s[i] - s[i - 1] > 1e-5
    return float((s[i - 1] + s[i]) / 2)


def test_weight_bridge_maps_every_leaf_once_and_round_trips(slice_run):
    flax_leaves = dict(_flat(slice_run.variables["params"]))
    sd = from_flax_variables(slice_run.variables)
    assert len(sd) == len(flax_leaves)
    assert set(sd) == set(slice_run.t_model.state_dict())
    back = dict(_flat(to_flax_variables(sd)["params"]))
    assert set(back) == set(flax_leaves)
    for path, v in flax_leaves.items():
        np.testing.assert_array_equal(back[path], v, err_msg="/".join(path))


def test_c4_features(slice_run):
    with torch.no_grad():
        got = slice_run.t_model.features(_t(slice_run.x)).numpy()
    want = slice_run.j_feat
    assert got.shape == want.shape == (B, H // 16, W // 16, 1024)
    # same float32 convolutions, different algorithms and summation order
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_rpn_scores(slice_run):
    with torch.no_grad():
        rpn = slice_run.t_model.rpn_scores(_t(slice_run.j_feat))
    # tolerance of the composite parity test: cross-backend fp noise
    np.testing.assert_allclose(rpn["fg_prob"].numpy(), slice_run.j_fg, atol=2e-3)
    np.testing.assert_allclose(rpn["deltas"].numpy(), slice_run.j_deltas, atol=2e-3)
    assert np.unique(slice_run.j_fg).size > 0.9 * slice_run.j_fg.size  # distinct scores


def test_proposals_on_pinned_scores(slice_run):
    """JAX scores and deltas in, so the ranking is identical: proposals must
    match index for index."""
    m = slice_run.t_model
    h, w = H // 16, W // 16
    anchors = m.anchors(h, w, torch.device("cpu"))
    rois, scores, valid, src = m._propose_batch(
        {"fg_prob": _t(slice_run.j_fg), "deltas": _t(slice_run.j_deltas)},
        anchors, _t(slice_run.window))
    j_rois, j_scores, _a3d, j_valid, j_src = slice_run.j_props
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_array_equal(src.numpy(), j_src)
    np.testing.assert_allclose(rois.numpy(), j_rois, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=1e-6)
    assert j_valid.sum() >= B * POST_N // 2


def test_top_mode_proposals_on_pinned_scores(slice_run):
    """TEST.MODE 'top': the NMS-free top-N path of propose_one."""
    m = slice_run.t_model
    anchors = m.anchors(H // 16, W // 16, torch.device("cpu"))
    top_n = 500
    rois, scores, valid, src = t_det.propose(
        _t(slice_run.j_fg), _t(slice_run.j_deltas), anchors, _t(slice_run.window),
        pre_nms_top_n=PRE_N, post_nms_top_n=top_n, nms_thresh=0.7, use_nms=False)
    want = jax.vmap(
        lambda f, d, w: j_det.propose_one(
            f, d, jnp.asarray(anchors.numpy()), jnp.zeros((anchors.shape[0], 7)), w,
            pre_nms_top_n=PRE_N, post_nms_top_n=top_n, nms_thresh=0.7, use_nms=False),
    )(jnp.asarray(slice_run.j_fg), jnp.asarray(slice_run.j_deltas), jnp.asarray(slice_run.window))
    j_rois, j_scores, _a3d, j_valid, j_src = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(src.numpy(), j_src)
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_allclose(rois.numpy(), j_rois, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(scores.numpy(), j_scores)
    assert rois.shape == (B, top_n, 4)


def test_rpn_only_forward(slice_run):
    """ENABLE_FULL_NET False returns the proposals alone, the same ones."""
    cfg = slice_run.tcfg.replace(enable_full_net=False)
    m = t_det.FasterRCNN(cfg, K)
    load_flax_variables(m, slice_run.variables)
    with torch.no_grad():
        out = m.eval().forward_test(_t(slice_run.x), _t(slice_run.window))
    assert set(out) == {"rois", "roi_scores", "roi_valid"}
    _j_rois, _j_scores, _a3d, j_valid, _src = slice_run.j_props
    np.testing.assert_array_equal(out["roi_valid"].numpy(), j_valid)


def test_second_stage_and_filter_on_pinned_rois(slice_run):
    m, j = slice_run.t_model, slice_run.j_out
    with torch.no_grad():
        cls_prob, boxes = m.classify_rois(
            _t(slice_run.j_feat), _t(j["rois"]), _t(slice_run.window))
    scale = np.abs(j["cls_prob"]).max()
    np.testing.assert_allclose(cls_prob.numpy(), j["cls_prob"], atol=3e-3 * scale)
    np.testing.assert_allclose(boxes.numpy(), j["bbox_pred"], atol=0.15)

    kw = dict(num_classes=K, bbox_elem=4, max_dets=100, thresh=_split_thresh(j["cls_prob"]),
              nms_thresh=0.6)
    got = t_filter(cls_prob, boxes, _t(j["roi_valid"]), **kw)
    n_kept = 0
    for i in range(B):
        want = j_filter(jnp.asarray(j["cls_prob"][i]), jnp.asarray(j["bbox_pred"][i]),
                        jnp.asarray(j["roi_valid"][i]), **kw)
        np.testing.assert_array_equal(got["valid"][i].numpy(), np.asarray(want["valid"]))
        np.testing.assert_array_equal(got["src_idx"][i].numpy(), np.asarray(want["src_idx"]))
        np.testing.assert_allclose(got["boxes"][i].numpy(), np.asarray(want["boxes"]), atol=0.15)
        np.testing.assert_allclose(got["scores"][i].numpy(), np.asarray(want["scores"]),
                                   atol=3e-3 * scale)
        n_kept += int(np.asarray(want["valid"]).sum())
    assert n_kept > 0


def test_forward_test_end_to_end(slice_run):
    """Unpinned: random-weight anchor scores are densely packed, so backend
    noise may reorder the top of the ranking; require 95% of the JAX
    proposals to reappear at IoU >= 0.99, and the final detections to match."""
    m, j = slice_run.t_model, slice_run.j_out
    with torch.no_grad():
        out = m.forward_test(_t(slice_run.x), _t(slice_run.window))
    assert set(out) == {"rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred"}
    matched = total = 0
    for i in range(B):
        jr = _t(j["rois"][i][j["roi_valid"][i]])
        tr = out["rois"][i][out["roi_valid"][i]]
        iou = _iou_plus1(jr, tr)
        matched += int((iou.max(dim=1).values >= 0.99).sum())
        total += jr.shape[0]
    assert matched >= 0.95 * total

    kw = dict(num_classes=K, bbox_elem=4, max_dets=100, thresh=_split_thresh(j["cls_prob"]),
              nms_thresh=0.6)
    got = t_filter(out["cls_prob"], out["bbox_pred"], out["roi_valid"], **kw)
    for i in range(B):
        want = j_filter(jnp.asarray(j["cls_prob"][i]), jnp.asarray(j["bbox_pred"][i]),
                        jnp.asarray(j["roi_valid"][i]), **kw)
        wv = np.asarray(want["valid"])
        gv = got["valid"][i].numpy()
        assert gv.sum() == wv.sum()
        for c in range(1, K):
            wb = _t(np.asarray(want["boxes"])[c][wv[c]])
            gb = got["boxes"][i, c][gv[c]]
            if len(wb):
                assert (_iou_plus1(wb, gb).max(dim=1).values >= 0.99).all()
