"""The FPN image detector, port vs the JAX package, on the CPU: res50 (the
same Bottleneck code as res101), float32, the port through its plain twins.

Both detectors share one set of weights: the flax FasterRCNN with USE_FPN
and POOLING_MODE multiscale is initialized, its BN statistics randomized
from a numpy seed and the residual terminators scaled to 0.25 (as bench.py
does); the port loads them through the weight bridge.  Covered: the pyramid
backbone and the FPN (also at 120x200, where the top-down upsampling is not
2x), the FCTail, multiscale RoI align (values, level ids on the
LevelMapper's boundaries, gradients), the weight bridge and the optimizer
masks, the serving slice at 128x192 and the training step, fed JAX's own
draws and pinned to its proposal lanes.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models.heads import FCTail as JFCTail  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.filter import filter_detections as j_filter  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.roi_align import (  # noqa: E402
    multiscale_roi_align_batched as j_msra,
)
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections as t_filter  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (  # noqa: E402
    multiscale_roi_align_batched,
    roi_levels,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.training import optim as t_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    from_flax_variables,
    load_flax_variables,
    load_torchvision_resnet,
    to_flax_variables,
)
from tests import test_torch_port_train as tt  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, H, W, K, G = tt.B, tt.H, tt.W, tt.K, tt.G  # 2 frames of 128x192, 2 classes, 8 GT
STRIDES = (4, 8, 16, 32)
FPN = ("USE_FPN", "True", "POOLING_MODE", "multiscale")
SERVING = (
    "NET_TYPE", "image", "NET_VARIANT", "res50", "COMPUTE_DTYPE", "float32",
    "PIXEL_STDDEVS", "[60.,60.,60.]", "TEST.SCALES", "(1.0,)",
    "STATIC.NMS_PRE_TEST", "2048", "TEST.RPN_POST_NMS_TOP_N", "32",
) + FPN
# at init most top-scored anchors of the stride-4 grid are large boxes clipped
# to the frame, which NMS folds into one: 2048 candidates keep enough proposals
TRAINING = tt.OVERRIDES + FPN + ("STATIC.NMS_PRE_TRAIN", "2048")


def _cfgs(overrides):
    """(JAX config, port config) from the same overrides."""
    return (cfg_from_list(default_config(), overrides),
            t_config.cfg_from_list(t_config.default_config(), overrides))


def _t(a):
    return torch.from_numpy(np.array(a))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def _iou_plus1(a, b):
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _split_thresh(cls_prob, valid):
    """A class-1 threshold halfway between the two middle scores of the
    valid rois (pad slots repeat the top box), so half of them pass and no
    score sits within backend noise of it."""
    s = np.sort(cls_prob[..., 1][valid])
    i = s.size // 2
    assert s[i] - s[i - 1] > 1e-5
    return float((s[i - 1] + s[i]) / 2)


@pytest.fixture(scope="module")
def serving():
    cfg, tcfg = _cfgs(SERVING)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    j_model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    variables = tt._shared_variables(j_model, x, window)

    def _stages(m, images, win):
        feats = m.features(images, deterministic=True)
        rpn = m.rpn_scores(feats["rpn"])
        rpn["anchors"] = m._anchors(feats["rpn"], phase="test")
        return feats["pyramid"], rpn, m._propose_batch(rpn, win, "test")

    j_pyr, j_rpn, j_props = j_model.apply(
        variables, jnp.asarray(x), jnp.asarray(window), method=_stages)
    j_out = j_model.apply(variables, jnp.asarray(x), jnp.asarray(window),
                          method=j_det.FasterRCNN.forward_test,
                          rngs={"dropout": jax.random.PRNGKey(0)})
    t_model = t_det.FasterRCNN(tcfg, K)
    load_flax_variables(t_model, variables)
    return types.SimpleNamespace(
        cfg=cfg, tcfg=tcfg, x=x, window=window, variables=variables, j_model=j_model,
        t_model=t_model.eval(), j_pyr=[np.asarray(p) for p in j_pyr],
        j_fg=np.asarray(j_rpn["fg_prob"]), j_deltas=np.asarray(j_rpn["deltas"]),
        j_props=[np.asarray(a) for a in j_props],
        j_out={k: np.asarray(v) for k, v in j_out.items() if k in
               ("rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred")},
    )


# -- modules ------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 96), (120, 200)])
def test_pyramid_and_fpn_match_jax(serving, hw):
    """c2..c5 and p2..p5; at 120x200 c4 (8x13) goes up to c3 (15x25) and p5
    (4x7) to p4 (8x13), upsampling ratios other than 2."""
    x = np.random.RandomState(hw[0]).uniform(-2, 2, (1,) + hw + (3,)).astype(np.float32)

    def _run(m, images):
        c = m.backbone(images)
        return c, m.fpn(*c)

    j_c, j_p = serving.j_model.apply(serving.variables, jnp.asarray(x), method=_run)
    m = serving.t_model
    with torch.no_grad():
        t_c = m.backbone(_t(x).permute(0, 3, 1, 2))
        t_p = m.fpn(*t_c)
    for name, got, want in zip(("c2", "c3", "c4", "c5", "p2", "p3", "p4", "p5"),
                               t_c + t_p, list(j_c) + list(j_p)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4, atol=3e-4,
                                   err_msg=name)
    if hw == (120, 200):
        assert [tuple(c.shape[1:3]) for c in j_c] == [(30, 50), (15, 25), (8, 13), (4, 7)]


def test_fc_tail_matches_jax(serving):
    pooled = np.random.RandomState(5).normal(size=(12, 7, 7, 256)).astype(np.float32)
    want = np.asarray(JFCTail(2048).apply(
        {"params": serving.variables["params"]["tail"]}, jnp.asarray(pooled)))
    with torch.no_grad():
        got = serving.t_model.tail(_t(pooled).reshape(12, -1)).numpy()
    assert (want > 0).mean() > 0.2  # the ReLUs pass a fair share
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# -- multiscale RoI align ----------------------------------------------------

MAP_HW = [(32, 48), (16, 24), (8, 12), (4, 6)]  # a 128x192 frame's p2..p5


def _boundary_rois():
    """Squares with sqrt(area) on the level boundaries 112, 224, 448 and
    +-1e-3 px off them, wide and flat boxes, degenerate boxes (zero width,
    negative width, negative width and height, a point), a box far outside
    the frame and one larger than the frame."""
    rois = []
    for s in (112.0, 224.0, 448.0):
        for d in (-1e-3, 0.0, 1e-3):
            rois.append([0.0, 0.0, s + d, s + d])
            rois.append([20.0, 8.0, 20.0 + (s + d) * 2.0, 8.0 + (s + d) / 2.0])
    rois += [[30.0, 40.0, 30.0, 90.0], [60.0, 10.0, 20.0, 50.0], [90.0, 80.0, 10.0, 10.0],
             [5.0, 5.0, 5.0, 5.0], [3000.0, 3000.0, 3100.0, 3120.0], [-50.0, -40.0, 900.0, 700.0]]
    return np.asarray(rois, np.float32)


def _ms_inputs(seed, c=8):
    rng = np.random.RandomState(seed)
    maps = [rng.normal(size=(B,) + hw + (c,)).astype(np.float32) for hw in MAP_HW]
    r = 40
    x1 = rng.uniform(-20, W, (B, r))
    y1 = rng.uniform(-20, H, (B, r))
    side = np.exp(rng.uniform(np.log(8), np.log(700), (B, r)))
    aspect = np.exp(rng.uniform(-1, 1, (B, r)))
    rois = np.stack([x1, y1, x1 + side * aspect, y1 + side / aspect], -1)
    rois = np.concatenate([rois, np.stack([_boundary_rois()] * B)], 1).astype(np.float32)
    return maps, rois


def _jax_levels(rois):
    """JAX's own level of each RoI: its multiscale pooling of constant maps
    whose value is the level index + 1."""
    maps = [jnp.full((B,) + hw + (1,), float(i + 1)) for i, hw in enumerate(MAP_HW)]
    out = np.asarray(j_msra(maps, jnp.asarray(rois), STRIDES))
    assert np.allclose(out, np.round(out), atol=1e-4)
    return np.round(out[..., 0, 0, 0]).astype(np.int64) - 1


def test_multiscale_levels_match_jax_on_the_boundaries():
    _maps, rois = _ms_inputs(0)
    want = _jax_levels(rois)
    got = roi_levels(_t(rois), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(want)) == {0, 1, 2, 3}
    # the boundary squares: -1e-3 px below, on and above 112, 224, 448
    squares = got[0, 40::2][:9]
    np.testing.assert_array_equal(squares, [0, 1, 1, 1, 2, 2, 2, 3, 3])


def test_multiscale_twin_matches_jax():
    maps, rois = _ms_inputs(1)
    want = np.asarray(j_msra([jnp.asarray(m) for m in maps], jnp.asarray(rois), STRIDES))
    got = multiscale_roi_align_batched([_t(m) for m in maps], _t(rois), STRIDES).numpy()
    assert got.shape == want.shape == (B, rois.shape[1], 7, 7, 8)
    fmax = max(np.abs(m).max() for m in maps)
    assert np.abs(got - want).max() <= 1e-5 * fmax


def test_multiscale_twin_gradient_matches_jax_vjp():
    maps, rois = _ms_inputs(2)
    g = np.random.RandomState(3).normal(size=(B, rois.shape[1], 7, 7, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda *ms: j_msra(ms, jnp.asarray(rois), STRIDES),
                     *[jnp.asarray(m) for m in maps])
    want = vjp(jnp.asarray(g))
    t_maps = [_t(m).requires_grad_(True) for m in maps]
    multiscale_roi_align_batched(t_maps, _t(rois), STRIDES).backward(_t(g))
    for i, (tm, w) in enumerate(zip(t_maps, want)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, f"level {i} got no RoI"
        assert np.abs(tm.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max(), f"level {i}"


# -- weight bridge, optimizer masks, supported configurations ------------------


def test_fpn_weight_bridge_maps_every_leaf_once_and_round_trips(serving):
    flax_leaves = dict(tt._flat(serving.variables["params"]))
    sd = from_flax_variables(serving.variables)
    assert len(sd) == len(flax_leaves)
    assert set(sd) == set(serving.t_model.state_dict())
    for key in ("fpn.latlayer5.weight", "fpn.aalayer4.bias", "tail.t_fc1.weight",
                "backbone.layer4.2.conv3.weight", "backbone.layer4.0.downsample.1.running_var"):
        assert key in sd, key
    assert sd["tail.t_fc1.weight"].shape == (2048, 7 * 7 * 256)
    back = dict(tt._flat(to_flax_variables(sd)["params"]))
    assert set(back) == set(flax_leaves)
    for path, v in flax_leaves.items():
        np.testing.assert_array_equal(back[path], v, err_msg="/".join(path))


def test_torchvision_resnet_loads_layer4_into_the_fpn_backbone():
    """A torchvision ResNet state dict (fc head, BN step counters) fills the
    pyramid backbone, layer4 included; the FPN and FCTail keep their init."""
    _, tcfg = _cfgs(SERVING)
    src = t_det.init_detector(tcfg, K, seed=1)
    tv = {k: v.clone() for k, v in src.backbone.state_dict().items()}
    tv.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
               "bn1.num_batches_tracked": torch.zeros((), dtype=torch.int64)})
    model = t_det.init_detector(tcfg, K, seed=2)
    fpn_before = model.fpn.latlayer2.weight.clone()
    assert load_torchvision_resnet(model, tv) == len(src.backbone.state_dict())
    assert torch.equal(model.backbone.layer4[2].conv3.weight, src.backbone.layer4[2].conv3.weight)
    assert torch.equal(model.fpn.latlayer2.weight, fpn_before)


def test_fpn_optimizer_masks_equal_jax(serving):
    params = serving.variables["params"]
    tcfg = serving.tcfg
    want_frozen = {flax_path_to_torch_key(p): bool(v)
                   for p, v in tt._flat(j_optim.frozen_mask(params, serving.cfg))}
    want_decay = {flax_path_to_torch_key(p): bool(v)
                  for p, v in tt._flat(j_optim.decay_mask(params, serving.cfg))}
    want_bias = {flax_path_to_torch_key(p): bool(v) for p, v in tt._flat(j_optim.bias_mask(params))}
    keys = list(serving.t_model.state_dict())
    assert t_optim.frozen_mask(keys, tcfg) == want_frozen
    assert t_optim.decay_mask(keys, tcfg) == want_decay
    assert t_optim.bias_mask(keys) == want_bias
    assert not want_frozen["backbone.layer4.0.conv2.weight"]
    assert not want_frozen["fpn.aalayer2.weight"] and want_frozen["backbone.layer1.0.conv1.weight"]


def test_check_supported_fpn_configurations():
    _, tcfg = _cfgs(SERVING)
    t_det.check_supported(tcfg)
    t_det.check_supported(tcfg, training=True)
    with pytest.raises(NotImplementedError, match="F2"):
        t_det.check_supported(tcfg.replace(pooling_mode="align"))
    # uncertainty, live BN and BEV rasters are ported on FPN; USE_LIDAR_FPN
    # is accepted and read by nothing, as in the JAX package
    t_det.check_supported(t_config.cfg_from_list(tcfg, ("UC.EN_CLS_ALEATORIC", "True")),
                          training=True)
    t_det.check_supported(t_config.cfg_from_list(tcfg, ("RESNET.FIXED_BLOCKS", "-1")),
                          training=True)
    lidar = t_config.cfg_from_list(t_config.default_config(), ("NET_TYPE", "lidar"))
    t_det.check_supported(lidar.replace(use_lidar_fpn=True))
    t_det.check_supported(lidar.replace(use_fpn=True, pooling_mode="multiscale"))
    for variant in ("vgg16", "mobile"):  # FPN is ResNet-only, as JAX asserts
        with pytest.raises(NotImplementedError, match="ResNet-only"):
            t_det.check_supported(tcfg.replace(net_variant=variant))


def test_fault_f2_jax_fpn_align_anchors_cover_four_frames():
    """Fault F2: in the JAX package USE_FPN with POOLING_MODE align lays
    stride-16 anchors over the stride-4 p2 grid, so their centres span 4x
    the frame (and p2 is pooled at 1/16).  The port raises for it."""
    cfg, tcfg = _cfgs(SERVING[:-2] + ("POOLING_MODE", "align"))
    assert j_det.feat_stride(cfg) == 16
    anchors, _ = j_det.build_anchor_grid(cfg, H // 4, W // 4, 1.0)
    cx = (anchors[:, 0] + anchors[:, 2]) / 2
    cy = (anchors[:, 1] + anchors[:, 3]) / 2
    assert cx.max() > 3.5 * W and cy.max() > 3.5 * H
    ok_cfg, _ = _cfgs(SERVING)
    ok, _ = j_det.build_anchor_grid(ok_cfg, H // 4, W // 4, 1.0)
    assert ((ok[:, 0] + ok[:, 2]) / 2).max() < W + 8  # the last cell's centre, 4 * 47 + 7.5
    with pytest.raises(NotImplementedError, match="F2"):
        t_det.FasterRCNN(tcfg, K)


# -- the serving slice ---------------------------------------------------------


def test_pyramid_and_rpn_scores(serving):
    with torch.no_grad():
        pyr = serving.t_model.features(_t(serving.x))
        rpn = serving.t_model.rpn_scores(pyr)
    assert [tuple(p.shape) for p in pyr] == [(B,) + hw + (256,) for hw in MAP_HW]
    for got, want in zip(pyr, serving.j_pyr):
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(rpn["fg_prob"].numpy(), serving.j_fg, atol=2e-3)
    np.testing.assert_allclose(rpn["deltas"].numpy(), serving.j_deltas, atol=2e-3)
    assert serving.j_fg.shape == (B, 32 * 48 * 25)
    assert np.unique(serving.j_fg).size > 0.9 * serving.j_fg.size


def test_fpn_proposals_on_pinned_scores(serving):
    m = serving.t_model
    anchors = m.anchors(H // 4, W // 4, torch.device("cpu"))
    rois, scores, valid, src = m._propose_batch(
        {"fg_prob": _t(serving.j_fg), "deltas": _t(serving.j_deltas)}, anchors,
        _t(serving.window))
    j_rois, j_scores, _a3d, j_valid, j_src = serving.j_props
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_array_equal(src.numpy(), j_src)
    np.testing.assert_allclose(rois.numpy(), j_rois, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=1e-6)
    assert j_valid.sum() >= B * 24


def test_fpn_second_stage_and_filter_on_pinned_rois(serving):
    m, j = serving.t_model, serving.j_out
    pyr = tuple(_t(p) for p in serving.j_pyr)
    levels = roi_levels(_t(j["rois"]), 4)
    assert len(torch.unique(levels)) >= 2  # the rois come from more than one level
    with torch.no_grad():
        cls_prob, boxes = m.classify_rois(pyr, _t(j["rois"]), _t(serving.window))
    scale = np.abs(j["cls_prob"]).max()
    np.testing.assert_allclose(cls_prob.numpy(), j["cls_prob"], atol=3e-3 * scale)
    np.testing.assert_allclose(boxes.numpy(), j["bbox_pred"], atol=0.15)
    kw = dict(num_classes=K, bbox_elem=4, max_dets=100, nms_thresh=0.6,
              thresh=_split_thresh(j["cls_prob"], j["roi_valid"]))
    got = t_filter(cls_prob, boxes, _t(j["roi_valid"]), **kw)
    n_kept = 0
    for i in range(B):
        want = j_filter(jnp.asarray(j["cls_prob"][i]), jnp.asarray(j["bbox_pred"][i]),
                        jnp.asarray(j["roi_valid"][i]), **kw)
        np.testing.assert_array_equal(got["valid"][i].numpy(), np.asarray(want["valid"]))
        np.testing.assert_array_equal(got["src_idx"][i].numpy(), np.asarray(want["src_idx"]))
        np.testing.assert_allclose(got["boxes"][i].numpy(), np.asarray(want["boxes"]), atol=0.15)
        n_kept += int(np.asarray(want["valid"]).sum())
    assert n_kept > 0


def test_fpn_forward_test_end_to_end(serving):
    m, j = serving.t_model, serving.j_out
    with torch.no_grad():
        out = m.forward_test(_t(serving.x), _t(serving.window))
    assert set(out) == {"rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred"}
    matched = total = 0
    for i in range(B):
        jr = _t(j["rois"][i][j["roi_valid"][i]])
        tr = out["rois"][i][out["roi_valid"][i]]
        matched += int((_iou_plus1(jr, tr).max(dim=1).values >= 0.99).sum())
        total += jr.shape[0]
    assert matched >= 0.95 * total
    kw = dict(num_classes=K, bbox_elem=4, max_dets=100, nms_thresh=0.6,
              thresh=_split_thresh(j["cls_prob"], j["roi_valid"]))
    got = t_filter(out["cls_prob"], out["bbox_pred"], out["roi_valid"], **kw)
    for i in range(B):
        want = j_filter(jnp.asarray(j["cls_prob"][i]), jnp.asarray(j["bbox_pred"][i]),
                        jnp.asarray(j["roi_valid"][i]), **kw)
        wv, gv = np.asarray(want["valid"]), got["valid"][i].numpy()
        assert gv.sum() == wv.sum()
        for c in range(1, K):
            wb = _t(np.asarray(want["boxes"])[c][wv[c]])
            gb = got["boxes"][i, c][gv[c]]
            if len(wb):
                assert (_iou_plus1(wb, gb).max(dim=1).values >= 0.99).all()


# -- the training step ---------------------------------------------------------


def _train_batch(cfg, seed=1):
    """tests/test_torch_port_train.py's batch (GT boxes jittered from the JAX
    proposals) on frames from `seed`."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    variables = tt._shared_variables(j_det.FasterRCNN(cfg=cfg, num_classes=K), x, window)
    rois, valid, _src = (np.asarray(a) for a in j_det.FasterRCNN(cfg=cfg, num_classes=K).apply(
        variables, jnp.asarray(x), jnp.asarray(window), method=tt._stages))
    gt = np.zeros((B, G, 5), np.float32)
    mask = np.zeros((B, G), bool)
    for i, n in enumerate([3, 5]):
        picks = rois[i][valid[i]][::7][:n]
        gt[i, :n, :4] = picks + rng.uniform(-2, 2, picks.shape)
        gt[i, :n, 4] = 1
        mask[i, :n] = True
    return {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": window}, variables


def _jax_site(inter, path, residual):
    """JAX's input to a chip_smoke.relu_sites ReLU from forward_train's
    intermediates (NHWC)."""
    parts = path.split(".")
    if path == "backbone.bn1":
        return np.asarray(inter["backbone"]["stem"]["bn1"]["__call__"][0])
    if parts[1].startswith("t_fc") or parts[1] == "rpn_net":
        return np.asarray(inter[parts[0]][parts[1]]["__call__"][0])
    root, layer, i, bn = parts
    stage = inter[root][layer]
    blk = stage[f"block{i}"]
    out = np.asarray(blk[bn]["__call__"][0])
    if not residual:
        return out
    if "downsample_bn" in blk:
        return out + np.asarray(blk["downsample_bn"]["__call__"][0])
    prev = stage[f"block{int(i) - 1}"] if int(i) else inter[root]["stem"]
    return out + np.asarray(prev["__call__"][0])


def _jax_intermediates(cfg, variables, batch, step_rng, num_classes=K):
    """Every module output of JAX's jitted forward_train (flax
    intermediates), as in the jitted gradients: XLA's fused convs round
    differently from eager ones and can move a unit at 0 across it."""
    jm = j_det.FasterRCNN(cfg=cfg, num_classes=num_classes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, state = jax.jit(lambda v: jm.apply(
        v, jb["data"], jb["gt_boxes"], jb["gt_mask"], jb["window"], step_rng,
        method=j_det.FasterRCNN.forward_train, capture_intermediates=True,
        mutable=["intermediates", "batch_stats"]))(variables)
    return state["intermediates"]


def _relu_ties(make_port, forward, inter, rounds=4):
    """Every ReLU unit (chip_smoke.relu_sites: the stem, every block, the C4
    tail's too, the RPN conv and the FCTail) whose input has a different
    sign in JAX's jitted forward_train (`inter`, _jax_intermediates) and in
    the port's (`forward` of a fresh `make_port()`): chip_smoke.find_ties's
    (module path, residual, index in the port's layout, JAX input, port
    input, max|JAX input| of that ReLU).  Such a unit sits at 0 within
    float32 rounding, and its ReLU passes gradient in one backend only;
    chip_smoke.pinned_ties gives it JAX's gate.  Pinning a tie moves what
    lies downstream of it by a rounding's worth (with live BN, its whole
    channel through the batch statistics), which can tip another unit: the
    ties are collected, pinned, until none is new."""
    ties = []
    for _ in range(rounds):
        model = make_port()
        with chip_smoke.pinned_ties(model, ties), chip_smoke.relu_inputs(model) as got:
            with torch.no_grad():
                forward(model)
        want = {}
        for (path, residual), tx in got.items():
            jx = _jax_site(inter, path, residual)
            jx = np.transpose(jx, (0, 3, 1, 2)) if jx.ndim == 4 else jx  # the port's NCHW
            assert np.abs(tx.numpy() - jx).max() <= 1e-4 * np.abs(jx).max() + 1e-12, path
            want[(path, residual)] = torch.from_numpy(np.ascontiguousarray(jx))
        new = chip_smoke.find_ties(want, got, skip={t[:3] for t in ties})
        if not new:
            break
        ties += new
    return ties


@pytest.fixture(scope="module")
def train_run():
    cfg, tcfg = _cfgs(TRAINING)
    batch, variables = _train_batch(cfg)
    j = tt._jax_run(cfg, variables, batch, jax.random.PRNGKey(3))
    n = (H // 4) * (W // 4) * cfg.num_anchors
    draws = tt.jax_draws(j.step_rng, B, n, j.n_rois, G)
    run = types.SimpleNamespace(cfg=cfg, tcfg=tcfg, batch=batch, variables=variables, j=j,
                                draws=draws)
    run.ties = _relu_ties(lambda: _port(run), lambda m: tt._forward(m, run),
                          _jax_intermediates(cfg, variables, batch, j.step_rng))
    return run


def _port(run):
    model = t_det.FasterRCNN(run.tcfg, K)
    load_flax_variables(model, run.variables)
    return model


def _torch_layout(w):
    return np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else (w.T if w.ndim == 2 else w)


def test_fpn_train_relu_ties_are_few_and_at_zero(train_run):
    """The units whose ReLU gate differs between the two backends are few,
    and each sits at 0 within 1e-5 of its ReLU's max|input| (float32 convs
    summed in different orders), not at a port fault.  On these frames
    there are two: c4 (layer3's last block) channel 233, and one unit of
    the RPN conv."""
    ties = train_run.ties
    print(f"ReLU ties: {ties}")
    assert len(ties) <= 4, ties
    for path, residual, at, jx, tx, scale in ties:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale, (path, residual, at, jx, tx, scale)


def test_fpn_train_lanes_and_labels_identical(train_run):
    model = _port(train_run)
    assert model.train_lane_counts((H, W), G)[0] == train_run.draws.anchor_fg.shape[1] == 38400
    with torch.no_grad():
        _losses, aux = tt._forward(model, train_run)
    np.testing.assert_array_equal(aux.proposal_targets.labels.numpy(), train_run.j.labels)
    assert (train_run.j.labels > 0).sum() >= 4 and (train_run.j.labels == 0).sum() >= 4
    pyr = model.features(_t(train_run.batch["data"]))
    anchors = model.anchors(H // 4, W // 4, torch.device("cpu"), "train")
    src, valid = model.select_proposals(model.rpn_scores(pyr), anchors,
                                        _t(train_run.batch["window"]))
    np.testing.assert_array_equal(valid.numpy(), train_run.j.valid)
    np.testing.assert_array_equal(src.numpy()[valid.numpy()],
                                  train_run.j.src[train_run.j.valid])


def test_fpn_train_losses_and_gradients(train_run):
    """The four losses within rtol 1e-4; every trainable leaf's gradient,
    fpn.*, backbone.layer4.* and tail.t_fc* among them, within 1e-3 of its
    max, each ReLU tie given JAX's gate (chip_smoke.pinned_ties;
    test_fpn_train_relu_ties_are_few_and_at_zero)."""
    model = _port(train_run)
    t_optim.DetectorSGD(model, train_run.tcfg)
    with chip_smoke.pinned_ties(model, train_run.ties):
        losses, _ = tt._forward(model, train_run)
    for k in tt.LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k]), train_run.j.losses[k], rtol=1e-4, err_msg=k)
    assert all(train_run.j.losses[k] > 0 for k in tt.LOSSES)
    losses["total_loss"].backward()
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    for prefix in ("fpn.", "backbone.layer4.", "tail.t_fc1.", "tail.t_fc3."):
        assert any(n.startswith(prefix) for n in trained), prefix
    for name in trained:
        p, want = dict(model.named_parameters())[name], _torch_layout(train_run.j.g_total[name])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=name)
    assert len(trained) >= 60


def test_fpn_one_train_step_matches_make_train_step(train_run):
    model = _port(train_run)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = t_solver.make_train_step(model, t_optim.DetectorSGD(model, train_run.tcfg))
    tb = {k: _t(v) for k, v in train_run.batch.items()}
    pin = (_t(train_run.j.src).long(), _t(train_run.j.valid))
    with chip_smoke.pinned_ties(model, train_run.ties):
        losses, _ = step(tb, train_run.draws, pin)
    np.testing.assert_allclose(float(losses["total_loss"]), train_run.j.losses["total_loss"],
                               rtol=1e-4)
    moved = 0
    for name, p in model.named_parameters():
        w = _torch_layout(train_run.j.new_params[name])
        want, got = w - start[name].numpy(), (p.detach() - start[name]).numpy()
        atol = 1e-3 * np.abs(want).max() + 1e-6 * np.abs(start[name].numpy()).max()
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
        moved += bool(np.abs(want).max() > 0)
    # all but fpn.aalayer4.bias: never applied, so no gradient, and no decay on
    # biases (its weight moves by weight decay alone)
    assert np.array_equal(train_run.j.new_params["fpn.aalayer4.bias"],
                          start["fpn.aalayer4.bias"].numpy())
    assert moved == sum(p.requires_grad for p in model.parameters()) - 1 >= 60
