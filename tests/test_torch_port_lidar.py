"""The LiDAR BEV serving slice, port vs the JAX package, on the CPU.

Module by module (the voxelizer's twin, the 3D anchors and the anchor grid,
the 7-DoF decode, the BEV envelope, the lidar final filter), then the whole
slice at res50 on two synthetic frames at scale 0.25 (a 200 x 175 x 15
raster, whose width is not a multiple of 16, as at the serving scale 0.5):
raw points -> voxelize_bev -> forward_test -> filter_detections(is_lidar).

The JAX side rasterizes as its loader does, under
jit(vmap(partial(voxelize_bev, **grid))) (data/loader.py:443-468): that is
the arithmetic the port copies (see ops/voxelize.py).  Both detectors share
one set of weights, built as in test_torch_port_slice.py.
"""

from __future__ import annotations

import math
import types
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import (  # noqa: E402
    cfg_from_list as j_cfg_from_list,
)
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import anchors as j_anchors  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import box_transform as j_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import iou as j_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.filter import (  # noqa: E402
    filter_detections as j_filter,
)
from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import (  # noqa: E402
    voxelize_bev as j_voxelize,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.config import (  # noqa: E402
    cfg_from_list,
    default_config,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import box_transform as t_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import iou as t_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (  # noqa: E402
    filter_detections as t_filter,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (  # noqa: E402
    bev_grid_size,
    raster_kwargs,
    voxelize_bev,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    from_flax_variables,
    load_flax_variables,
    to_flax_variables,
)

B, K, SCALE, PRE_N, POST_N = 2, 2, 0.25, 256, 32
S = 12  # LIDAR.NUM_SLICES: channels [0, S) heights, S density, S + 1, S + 2 meta


def _overrides(*extra):
    return ("NET_TYPE", "lidar", "NET_VARIANT", "res50", "COMPUTE_DTYPE", "float32",
            "TRAIN.SCALES", f"({SCALE},)", "TEST.SCALES", f"({SCALE},)",
            "STATIC.NMS_PRE_TEST", str(PRE_N), "TEST.RPN_POST_NMS_TOP_N", str(POST_N),
            "STATIC.MAX_POINTS", "9000") + extra


def _cfgs(*extra):
    """(JAX config, port config) from one override list."""
    o = _overrides(*extra)
    return j_cfg_from_list(j_default(), o), cfg_from_list(default_config(), o)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_raster(grid):
    return jax.jit(jax.vmap(partial(j_voxelize, **grid)))


# -- the voxelizer's twin ----------------------------------------------------


def _points(case, rng, grid, b=2, p=6000):
    (x0, x1), (y0, y1), (z0, z1) = grid["x_range"], grid["y_range"], grid["z_range"]
    nx, ny, ns, vh = grid["num_x"], grid["num_y"], grid["num_slices"], grid["voxel_height"]
    pts = np.stack([rng.uniform(x0, x1, (b, p)), rng.uniform(y0, y1, (b, p)),
                    rng.uniform(z0, z1, (b, p)), rng.uniform(0, 1, (b, p)),
                    rng.uniform(0, 0.3, (b, p))], -1)
    valid = np.ones((b, p), bool)
    if case == "boundaries":  # every point on a cell and a slice boundary
        pts[..., 0] = x0 + rng.randint(-1, nx + 2, (b, p)) * ((x1 - x0) / nx)
        pts[..., 1] = y0 + rng.randint(-1, ny + 2, (b, p)) * ((y1 - y0) / ny)
        pts[..., 2] = z0 + rng.randint(-1, ns + 2, (b, p)) * vh
    elif case == "invalid_lanes":
        valid = rng.uniform(size=(b, p)) < 0.6
    elif case == "out_of_range":
        far = rng.uniform(size=(b, p, 3)) < 0.2
        pts[..., :3] = np.where(far, rng.uniform(-1e4, 1e4, (b, p, 3)), pts[..., :3])
    elif case == "overfull_voxel":  # 40 and 33 points in two voxels
        pts[:, :40, :3] = [x0 + 3.3, y0 + 7.7, z0 + 1.2]
        pts[:, 40:73, :3] = [x1 - 0.01, y1 - 0.01, z0 + ns * vh - 0.01]
    elif case == "all_invalid_frame":
        pts[1], valid[1] = 0.0, False
    return pts.astype(np.float32), valid


@pytest.mark.parametrize("scale", [0.5, 0.25])
@pytest.mark.parametrize("case", ["random", "boundaries", "invalid_lanes", "out_of_range",
                                  "overfull_voxel", "all_invalid_frame"])
def test_voxelize_twin_matches_jax(case, scale):
    """Heights and density equal; the meta channels (tanh of column means of
    float sums taken in another order) within 1e-5."""
    _, cfg = _cfgs()
    grid = raster_kwargs(cfg, scale)
    pts, valid = _points(case, np.random.RandomState(len(case)), grid)
    want = np.asarray(_jax_raster(grid)(jnp.asarray(pts), jnp.asarray(valid)))
    got = voxelize_bev(_t(pts), _t(valid), **grid).numpy()
    assert got.shape == want.shape == (2,) + bev_grid_size(cfg, scale)
    np.testing.assert_array_equal(got[..., :S + 1], want[..., :S + 1])
    np.testing.assert_allclose(got[..., S + 1:], want[..., S + 1:], rtol=0, atol=1e-5)
    assert (want[..., S] > 0).sum() > (0 if case != "all_invalid_frame" else 100)
    if case == "overfull_voxel":
        assert want[..., S].max() == 1.0  # the density caps at 32 points
    if case == "all_invalid_frame":
        assert not got[1].any()


def test_bev_grid_size_keeps_python_float_arithmetic():
    _, cfg = _cfgs()
    assert bev_grid_size(cfg, 0.5) == (400, 350, 15)
    assert bev_grid_size(cfg, 1.0) == (800, 700, 15)
    assert bev_grid_size(cfg, 0.25) == (200, 175, 15)


# -- anchors -------------------------------------------------------------------


@pytest.mark.parametrize("frame_scale", [0.5, 0.25])
def test_3d_anchors_equal(frame_scale):
    kw = dict(anchor_sizes_lwh=((4.73, 2.08, 1.77), (0.8, 0.6, 1.7)),
              anchor_rotations=(0.0, math.pi / 2), voxel_len=0.1, frame_scale=frame_scale)
    n_j, a_j = j_anchors.generate_3d_anchors(25, 22, 16, **kw)
    n_t, a_t = t_anchors.generate_3d_anchors(25, 22, 16, **kw)
    assert n_t == n_j == 25 * 22 * 4
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(t_anchors.anchors_3d_to_bev_aabb(a_t),
                                  j_anchors.anchors_3d_to_bev_aabb(a_j))


@pytest.mark.parametrize("substride", [1, 4, 16])
@pytest.mark.parametrize("feat_hw", [(25, 22), (13, 11)])
def test_anchor_grid_equals_jax(substride, feat_hw):
    """Substride 16 tiles every voxel (fine stride 1), which drops the last
    row and column of the 3D grid: the edge padding fills them."""
    jc, tc = _cfgs("LIDAR.ANCHOR_SUBSTRIDE", str(substride))
    want_bev, want_3d = j_det.build_anchor_grid(jc, *feat_hw, 0.5)
    got_bev, got_3d = t_det.build_anchor_grid(tc, *feat_hw, 0.5)
    assert got_bev.shape == (feat_hw[0] * feat_hw[1] * 2 * substride**2, 4)
    np.testing.assert_array_equal(got_bev, want_bev)
    np.testing.assert_array_equal(got_3d, want_3d)


# -- 7-DoF geometry ------------------------------------------------------------


def _rois_and_deltas(rng, n=64, k=2):
    xy = rng.uniform(0, 300, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2))], 1).astype(np.float32)
    a3d = np.stack([rng.uniform(0, 300, n), rng.uniform(0, 300, n), rng.uniform(0.5, 1, n),
                    rng.uniform(10, 30, n), rng.uniform(5, 12, n), rng.uniform(1.5, 2, n),
                    rng.choice([0, math.pi / 2], n)], 1).astype(np.float32)
    deltas = rng.normal(0, 0.3, (n, 7 * k)).astype(np.float32)
    return rois, a3d, deltas


def test_lidar_decode_and_bev_envelope():
    rois, a3d, deltas = _rois_and_deltas(np.random.RandomState(0))
    want = np.asarray(j_bt.lidar_3d_bbox_transform_inv(jnp.asarray(rois), jnp.asarray(a3d),
                                                        jnp.asarray(deltas)))
    got = t_bt.lidar_3d_bbox_transform_inv(_t(rois), _t(a3d), _t(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    boxes = want.reshape(-1, 7)
    np.testing.assert_allclose(t_iou.bbox_3d_to_bev_aabb(_t(boxes)).numpy(),
                               np.asarray(j_iou.bbox_3d_to_bev_aabb(jnp.asarray(boxes))),
                               rtol=1e-6, atol=1e-5)


def test_lidar_filter_keeps_equal_jax():
    """Per-class NMS on the center +- (l, w) / 2 footprints, one batched
    launch over (frame, class), against JAX's per-frame filter."""
    rng = np.random.RandomState(1)
    n = 200
    cls_prob = rng.dirichlet([1.0, 1.0], (B, n)).astype(np.float32)
    boxes = np.stack([rng.uniform(0, 20, (B, n)), rng.uniform(0, 20, (B, n)), rng.uniform(0, 2, (B, n)),
                      rng.uniform(8, 25, (B, n)), rng.uniform(4, 10, (B, n)),
                      rng.uniform(1, 2, (B, n)), rng.uniform(-3, 3, (B, n))], -1)
    pred = np.concatenate([boxes, boxes + 1.0], -1).astype(np.float32)  # (B, n, 7K)
    roi_valid = rng.uniform(size=(B, n)) < 0.9
    kw = dict(num_classes=K, bbox_elem=7, max_dets=100, thresh=0.3, nms_thresh=0.6, is_lidar=True)
    got = t_filter(_t(cls_prob), _t(pred), _t(roi_valid), **kw)
    kept = 0
    for i in range(B):
        want = j_filter(jnp.asarray(cls_prob[i]), jnp.asarray(pred[i]), jnp.asarray(roi_valid[i]), **kw)
        for k in ("valid", "src_idx", "boxes", "scores"):
            np.testing.assert_array_equal(got[k][i].numpy(), np.asarray(want[k]), err_msg=k)
        kept += int(np.asarray(want["valid"]).sum())
    assert 0 < kept < B * 100
    with pytest.raises(NotImplementedError):
        t_filter(_t(cls_prob), _t(pred), _t(roi_valid), **kw, rotated_nms=True)


@pytest.mark.parametrize("extra,training", [
    ((), True),
    (("USE_LIDAR_FPN", "True"), False),
    (("TEST.ROTATED_NMS", "True"), False),
    (("RESNET.FIXED_BLOCKS", "-1"), False),
])
def test_unported_lidar_options_raise(extra, training):
    _, cfg = _cfgs(*extra)
    with pytest.raises(NotImplementedError):
        t_det.check_supported(cfg, training=training)
    t_det.check_supported(_cfgs()[1])  # lidar serving is ported


# -- the whole slice -------------------------------------------------------------


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
def bev_run():
    jc, tc = _cfgs()
    db = SyntheticDataset(tc, num_frames=B, mode="val", seed=3)
    frames = [db.frame(i) for i in range(B)]
    p = tc.static.max_points
    pts = np.zeros((B, p, 5), np.float32)
    valid = np.zeros((B, p), bool)
    for i, f in enumerate(frames):
        pts[i, : len(f["points"])] = f["points"][:p]
        valid[i, : len(f["points"])] = True
    window = np.stack([f["window"] for f in frames])
    grid = raster_kwargs(tc, SCALE)
    j_x = np.asarray(_jax_raster(grid)(jnp.asarray(pts), jnp.asarray(valid)))

    j_model = j_det.FasterRCNN(cfg=jc, num_classes=K)
    variables = _shared_variables(j_model, j_x, window)

    def _stages(m, images, win):
        feats = m.features(images, deterministic=True)
        rpn = m.rpn_scores(feats["rpn"])
        rpn["anchors"] = m._anchors(feats["rpn"], phase="test")
        return feats["rpn"], rpn, m._propose_batch(rpn, win, "test")

    j_feat, j_rpn, j_props = j_model.apply(variables, jnp.asarray(j_x), jnp.asarray(window),
                                           method=_stages)
    j_out = j_model.apply(variables, jnp.asarray(j_x), jnp.asarray(window),
                          method=j_det.FasterRCNN.forward_test,
                          rngs={"dropout": jax.random.PRNGKey(0)})
    t_model = t_det.FasterRCNN(tc, K)
    load_flax_variables(t_model, variables)
    t_model.eval()
    return types.SimpleNamespace(
        pts=pts, valid=valid, window=window, grid=grid, j_x=j_x, t_model=t_model,
        variables=variables,
        j_feat=np.asarray(j_feat), j_fg=np.asarray(j_rpn["fg_prob"]),
        j_deltas=np.asarray(j_rpn["deltas"]), j_props=[np.asarray(a) for a in j_props],
        j_out={k: np.asarray(v) for k, v in j_out.items() if k in
               ("rois", "roi_scores", "roi_valid", "anchors_3d", "cls_prob", "bbox_pred")},
    )


def _aabb_iou(a, b):
    """IoU with +1 areas of the (x, y, l, w) footprints of 7-DoF boxes."""
    fa = torch.cat([a[:, :2] - a[:, 3:5] / 2, a[:, :2] + a[:, 3:5] / 2], 1)
    fb = torch.cat([b[:, :2] - b[:, 3:5] / 2, b[:, :2] + b[:, 3:5] / 2], 1)
    area_a = (fa[:, 2] - fa[:, 0] + 1) * (fa[:, 3] - fa[:, 1] + 1)
    area_b = (fb[:, 2] - fb[:, 0] + 1) * (fb[:, 3] - fb[:, 1] + 1)
    iw = (torch.minimum(fa[:, None, 2], fb[None, :, 2])
          - torch.maximum(fa[:, None, 0], fb[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(fa[:, None, 3], fb[None, :, 3])
          - torch.maximum(fa[:, None, 1], fb[None, :, 1]) + 1).clamp(min=0)
    return iw * ih / (area_a[:, None] + area_b[None, :] - iw * ih)


def _split_thresh(cls_prob):
    """A class-1 threshold in the widest gap among the middle third of the
    scores, so about half pass and none sits within backend noise of it."""
    s = np.sort(cls_prob[..., 1].ravel())
    lo, hi = s.size // 3, 2 * s.size // 3
    i = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    assert s[i + 1] - s[i] > 1e-5
    return float((s[i] + s[i + 1]) / 2)


def test_weight_bridge_carries_the_lidar_net(bev_run):
    """The 15-channel stem and the 7K-wide box head convert both ways."""
    flax_leaves = dict(_flat(bev_run.variables["params"]))
    sd = from_flax_variables(bev_run.variables)
    assert sd["backbone.conv1.weight"].shape == (64, 15, 7, 7)
    assert sd["predictors.bbox_pred_net.weight"].shape == (7 * K, 2048)
    assert set(sd) == set(bev_run.t_model.state_dict())
    back = dict(_flat(to_flax_variables(sd)["params"]))
    assert set(back) == set(flax_leaves)
    for path, v in flax_leaves.items():
        np.testing.assert_array_equal(back[path], v, err_msg="/".join(path))


def test_raster_and_c4_features(bev_run):
    x = voxelize_bev(_t(bev_run.pts), _t(bev_run.valid), **bev_run.grid)
    assert x.shape == (B, 200, 175, 15)
    np.testing.assert_array_equal(x[..., :S + 1].numpy(), bev_run.j_x[..., :S + 1])
    np.testing.assert_allclose(x[..., S + 1:].numpy(), bev_run.j_x[..., S + 1:], atol=1e-5)
    with torch.no_grad():
        feat = bev_run.t_model.features(x).numpy()
    want = bev_run.j_feat
    assert feat.shape == want.shape == (B, 13, 11, 1024)
    assert np.abs(feat - want).max() <= 1e-4 * np.abs(want).max()


def test_rpn_and_proposals_in_lanes(bev_run):
    m = bev_run.t_model
    with torch.no_grad():
        rpn = m.rpn_scores(_t(bev_run.j_feat))
    np.testing.assert_allclose(rpn["fg_prob"].numpy(), bev_run.j_fg, atol=2e-3)
    np.testing.assert_allclose(rpn["deltas"].numpy(), bev_run.j_deltas, atol=2e-3)
    # pinned to the JAX scores: the same lanes, boxes and 3D anchors
    anchors, anchors_3d = m.anchor_grids(13, 11, torch.device("cpu"))
    rois, scores, valid, src = m._propose_batch(
        {"fg_prob": _t(bev_run.j_fg), "deltas": _t(bev_run.j_deltas)}, anchors, _t(bev_run.window))
    j_rois, j_scores, j_a3d, j_valid, j_src = bev_run.j_props
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_array_equal(src.numpy(), j_src)
    np.testing.assert_array_equal(anchors_3d[src].numpy(), j_a3d)
    np.testing.assert_allclose(rois.numpy(), j_rois, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=1e-6)
    assert j_valid.sum() >= B * POST_N // 2


def test_second_stage_on_pinned_rois(bev_run):
    m, j = bev_run.t_model, bev_run.j_out
    with torch.no_grad():
        cls_prob, boxes = m.classify_rois(_t(bev_run.j_feat), _t(j["rois"]), _t(bev_run.window),
                                          _t(j["anchors_3d"]))
    scale = np.abs(j["cls_prob"]).max()
    np.testing.assert_allclose(cls_prob.numpy(), j["cls_prob"], atol=3e-3 * scale)
    assert boxes.shape == (B, POST_N, 7 * K)
    np.testing.assert_allclose(boxes.numpy(), j["bbox_pred"], atol=0.15)


def test_slice_end_to_end(bev_run):
    """Raw points to final detections, unpinned: 95% of the JAX proposals
    reappear at IoU >= 0.99, each proposal's 3D anchor matches, and the final
    detections match in count and footprint."""
    m, j = bev_run.t_model, bev_run.j_out
    with torch.no_grad():
        x = voxelize_bev(_t(bev_run.pts), _t(bev_run.valid), **bev_run.grid)
        out = m.forward_test(x, _t(bev_run.window))
    assert set(out) == {"rois", "roi_scores", "roi_valid", "anchors_3d", "cls_prob", "bbox_pred"}
    matched = total = 0
    for i in range(B):
        jr = _t(j["rois"][i][j["roi_valid"][i]])
        tr = out["rois"][i][out["roi_valid"][i]]
        area = lambda r: (r[:, 2] - r[:, 0] + 1) * (r[:, 3] - r[:, 1] + 1)  # noqa: E731
        iw = (torch.minimum(jr[:, None, 2], tr[None, :, 2])
              - torch.maximum(jr[:, None, 0], tr[None, :, 0]) + 1).clamp(min=0)
        ih = (torch.minimum(jr[:, None, 3], tr[None, :, 3])
              - torch.maximum(jr[:, None, 1], tr[None, :, 1]) + 1).clamp(min=0)
        iou = iw * ih / (area(jr)[:, None] + area(tr)[None, :] - iw * ih)
        best, at = iou.max(dim=1)
        matched += int((best >= 0.99).sum())
        total += jr.shape[0]
        ja = _t(j["anchors_3d"][i][j["roi_valid"][i]])
        ta = out["anchors_3d"][i][out["roi_valid"][i]][at]
        assert torch.equal(ja[best >= 0.99], ta[best >= 0.99])
    assert matched >= 0.95 * total

    kw = dict(num_classes=K, bbox_elem=7, max_dets=100, thresh=_split_thresh(j["cls_prob"]),
              nms_thresh=0.6, is_lidar=True)
    got = t_filter(out["cls_prob"], out["bbox_pred"], out["roi_valid"], **kw)
    n_dets = 0
    for i in range(B):
        want = j_filter(jnp.asarray(j["cls_prob"][i]), jnp.asarray(j["bbox_pred"][i]),
                        jnp.asarray(j["roi_valid"][i]), **kw)
        wv, gv = np.asarray(want["valid"]), got["valid"][i].numpy()
        assert gv.sum() == wv.sum()
        for c in range(1, K):
            wb = _t(np.asarray(want["boxes"])[c][wv[c]])
            gb = got["boxes"][i, c][gv[c]]
            if len(wb):
                assert (_aabb_iou(wb, gb).max(dim=1).values >= 0.99).all()
        n_dets += int(wv.sum())
    assert n_dets > 0
