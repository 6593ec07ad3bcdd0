"""FPN on LiDAR BEV rasters, the PyTorch port against the JAX package, on
the CPU, in float32: res18 ResNetPyramid with the 15-channel BEV stem, the
FPN, the RPN on p2 at stride 4 over the BEV anchors, multiscale pooling of
the BEV RoIs (every one of them on p2: BEV boxes are far under 224 voxels
a side), FCTail and the 7-DoF decode, on two 200 x 175 x 15 rasters at
scale 0.25.

Serving (forward_test): proposals, their 3D anchors, the class
probabilities and the 7-DoF boxes within 1e-5 of max|x|; then the
final filter with axis-aligned NMS at 0.6 and with TEST.ROTATED_NMS at 0.3
(test_torch_port_lidar's checks).  One training step (the lidar targets,
the 7-DoF box loss): the losses within rtol 1e-4, every trainable leaf's
gradient within 1e-3 of its max|g| (test_torch_port_backbones.
check_train_step: the second stage pinned to JAX's proposal lanes, JAX's
draws, ReLU ties pinned).  USE_LIDAR_FPN, which the JAX package declares and
never reads, leaves the port's outputs bit for bit as they are.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.filter import filter_detections as j_filter  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections as t_filter  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import roi_levels  # noqa: E402
from tests.test_torch_port_backbones import (  # noqa: E402
    BEV,
    _clipped_normal,
    _port,
    check_serving,
    check_train_step,
    serve_and_step,
)
from tests.test_torch_port_lidar import _aabb_iou, _split_thresh  # noqa: E402
from tests.test_torch_port_uc import _cfgs, _shared_variables, _t  # noqa: E402

B, K = 2, 2
FPN_BEV = BEV + ("NET_VARIANT", "res18", "USE_FPN", "True", "POOLING_MODE", "multiscale")


def _variables(tcfg):
    """test_torch_port_uc._shared_variables (BN randomized, the RPN's 1x1
    heads at 0.02), init_params' truncated normals drawn faster."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_det, "_trunc_normal", _clipped_normal)
        return _shared_variables(tcfg)


@pytest.fixture(scope="module")
def run():
    return serve_and_step("fpn-bev", FPN_BEV, _variables)


def test_fpn_bev_anchor_grid_equals_jax(run):
    """The train- and test-phase BEV anchors at stride 4 over p2's 50 x 44
    cells (the 3D anchors and their AABB footprints) are JAX's
    build_anchor_grid, and the map is ceil(200 / 4) x ceil(175 / 4)."""
    model = _port(run.tcfg, run.state)
    assert t_det.feat_stride(run.tcfg) == 4
    fh, fw = model.feature_hw(run.batch["data"].shape[1:3])
    assert (fh, fw) == (50, 44)
    for phase in ("train", "test"):
        scale = float(run.cfg.phase(phase).scales[0])
        want = j_det.build_anchor_grid(run.cfg, fh, fw, scale)
        got = t_det.build_anchor_grid(run.tcfg, fh, fw, scale)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert run.n_anchors == fh * fw * run.tcfg.num_anchors


def test_fpn_bev_serving_matches_jax(run):
    """Proposals, their validity, scores and 3D anchors, cls_prob and the
    7-DoF boxes within 1e-5 of max|x| of JAX's; every proposal is pooled
    from p2."""
    check_serving(run)
    rois = run.served["rois"][run.served["roi_valid"]]
    assert (roi_levels(rois, 4) == 0).all()


@pytest.mark.parametrize("rotated,nms_thresh", [(False, 0.6), (True, 0.3)],
                         ids=["aligned", "rotated"])
def test_fpn_bev_final_filter_matches_jax(run, rotated, nms_thresh):
    """The final filter on each side's own outputs, with axis-aligned NMS or
    TEST.ROTATED_NMS: the same number of detections a frame and class, each
    JAX box matched at footprint IoU >= 0.99."""
    got_out, want = run.served, run.want
    kw = dict(num_classes=K, bbox_elem=7, max_dets=100, thresh=_split_thresh(want["cls_prob"]),
              nms_thresh=nms_thresh, is_lidar=True, rotated_nms=rotated)
    got = t_filter(got_out["cls_prob"], got_out["bbox_pred"], got_out["roi_valid"], **kw)
    n_dets = 0
    for i in range(B):
        w = j_filter(jnp.asarray(want["cls_prob"][i]), jnp.asarray(want["bbox_pred"][i]),
                     jnp.asarray(want["roi_valid"][i]), **kw)
        wv, gv = np.asarray(w["valid"]), got["valid"][i].numpy()
        assert gv.sum() == wv.sum()
        for c in range(1, K):
            wb = _t(np.asarray(w["boxes"])[c][wv[c]])
            gb = got["boxes"][i, c][gv[c]]
            if len(wb):
                assert (_aabb_iou(wb, gb).max(dim=1).values >= 0.99).all()
        n_dets += int(wv.sum())
    assert n_dets > 0


def test_fpn_bev_train_step_losses_and_gradients(run):
    """One BEV training step: the RPN's losses over the p2 anchors, the
    7-DoF box loss against each RoI's 3D anchor, within rtol 1e-4; every
    trainable leaf's gradient within 1e-3 of its max|g|."""
    check_train_step(run, {"fpn.latlayer2.weight", "tail.t_fc1.weight",
                           "backbone.layer2.0.conv1.weight", "backbone.layer4.1.conv2.weight",
                           "predictors.bbox_pred_net.weight"})


def test_use_lidar_fpn_changes_nothing(run):
    """USE_LIDAR_FPN is accepted and read by nothing, as in the JAX package
    (which declares it, config.py:373, and never reads it): with it the
    port builds the same state dict, and the same weights give bit for bit
    the same outputs."""
    _, tcfg = _cfgs(FPN_BEV + ("USE_LIDAR_FPN", "True"))
    assert tcfg.use_lidar_fpn
    x, window = (_t(run.batch[k]) for k in ("data", "window"))
    model = _port(tcfg, run.state).eval()
    with torch.no_grad():
        got = model.forward_test(x, window)
    for k, v in run.served.items():
        assert torch.equal(got[k], v), k
