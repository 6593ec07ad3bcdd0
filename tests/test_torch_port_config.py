"""The port's own copies of the JAX package's framework-neutral modules:
config, synthetic data, the batch loader and the evaluation, each held
against the JAX original on the same inputs (CPU)."""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu import config as j_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import loader as j_loader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import synthetic as j_synth  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.evaluation import eval_utils as j_eval  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import voxelize_bev as j_voxelize  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import cli  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data import loader as t_loader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data import synthetic as t_synth  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation import eval_utils as t_eval  # noqa: E402

# the override lists of bench.py:196-228 and of the CLIs' flags
IMAGE = ("NET_TYPE", "image", "NET_VARIANT", "res101", "PIXEL_STDDEVS", "[60.,60.,60.]",
         "TRAIN.RPN_POST_NMS_TOP_N", "2000", "STATIC.NMS_PRE_TRAIN", "4096", "STATIC.MAX_GT", "64")
BEV = ("NET_TYPE", "lidar", "NET_VARIANT", "res101", "TRAIN.SCALES", "(0.5,)",
       "TRAIN.RPN_POST_NMS_TOP_N", "2000", "STATIC.NMS_PRE_TRAIN", "1024", "STATIC.MAX_GT", "64",
       "STATIC.MAX_POINTS", "32768")
CLI = ("NET_TYPE", "lidar", "NET_VARIANT", "res50", "ENABLE_FULL_NET", True, "USE_FPN", False,
       "TRAIN.SCALES", (0.5,), "TEST.SCALES", (0.5,), "RESNET.FIXED_BLOCKS", 2,
       "UC.EN_BBOX_ALEATORIC", True, "TRAIN.LIDAR.BBOX_NORMALIZE_STDS", "[0.1,0.1,0.1,0.2,0.2,0.2,1.0]",
       "DB_NAME", "synthetic", "TEST.RPN_POST_NMS_TOP_N", "300", "LIDAR.ANCHORS", "[[4.0, 2.0, 1.5]]")


@pytest.mark.parametrize("overrides", [(), IMAGE, BEV, CLI], ids=["defaults", "image", "bev", "cli"])
def test_config_equals_the_jax_config(overrides):
    want = j_config.cfg_from_list(j_config.default_config(), overrides)
    got = t_config.cfg_from_list(t_config.default_config(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_anchors, got.num_bbox_elem, got.lidar.num_channel) == (
        want.num_anchors, want.num_bbox_elem, want.lidar.num_channel)


def test_config_rejects_what_the_jax_config_rejects():
    for bad in (("NO_SUCH_KEY", "1"), ("LIDAR.NUM_CHANNEL", "3"), ("TRAIN.SCALES",)):
        with pytest.raises(Exception) as want:
            j_config.cfg_from_list(j_config.default_config(), bad)
        with pytest.raises(want.type):
            t_config.cfg_from_list(t_config.default_config(), bad)


def test_cli_builds_the_jax_cli_config():
    """The port's copy of build_config / args_to_train_ns on test flags."""
    argv = ["--net", "res50", "--net_type", "lidar", "--scale", "0.5", "--fixed_blocks", "2",
            "--set", "TEST.RPN_POST_NMS_TOP_N", "300"]
    args = cli.test_parser().parse_args(argv)
    got = cli.build_config(cli.args_to_train_ns(args))
    want = j_config.cfg_from_list(j_config.default_config(), (
        "NET_TYPE", "lidar", "NET_VARIANT", "res50", "ENABLE_FULL_NET", True, "USE_FPN", False,
        "RESNET.FIXED_BLOCKS", 2, "TRAIN.SCALES", (0.5,), "TEST.SCALES", (0.5,),
        "DB_NAME", "synthetic", "TEST.RPN_POST_NMS_TOP_N", "300"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert args.device == "cuda"
    with pytest.raises(NotImplementedError):
        cli.build_dataset(got, "waymo", "val")


@pytest.mark.parametrize("net_type", ["image", "lidar"])
@pytest.mark.parametrize("augment", [False, True])
def test_synthetic_frames_equal(net_type, augment):
    overrides = ("NET_TYPE", net_type, "TRAIN.SCALES", "(0.5,)", "TEST.SCALES", "(0.5,)")
    jc = j_config.cfg_from_list(j_config.default_config(), overrides)
    tc = t_config.cfg_from_list(t_config.default_config(), overrides)
    jd = j_synth.SyntheticDataset(jc, num_frames=4, mode="val", seed=5, image_hw=(64, 96))
    td = t_synth.SyntheticDataset(tc, num_frames=4, mode="val", seed=5, image_hw=(64, 96))
    assert (td.name, td.classes) == (jd.name, jd.classes)
    for i in range(4):
        want = jd.frame(i, augment=augment, rng=np.random.RandomState(i))
        got = td.frame(i, augment=augment, rng=np.random.RandomState(i))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_raster(cfg):
    """The JAX loader's raster function, as its _make_raster_fn builds it."""
    from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import bev_grid_size

    scale = float(cfg.train.scales[0])
    num_y, num_x, _ = bev_grid_size(cfg, scale)
    fn = partial(j_voxelize, x_range=cfg.lidar.x_range, y_range=cfg.lidar.y_range,
                 z_range=cfg.lidar.z_range, voxel_len=cfg.lidar.voxel_len / scale,
                 voxel_height=cfg.lidar.voxel_height, num_x=num_x, num_y=num_y,
                 num_slices=cfg.lidar.num_slices, num_meta=cfg.lidar.num_meta_channel,
                 max_pts_per_voxel=cfg.lidar.max_pts_per_voxel)
    return jax.jit(jax.vmap(fn))


@pytest.mark.parametrize("net_type", ["image", "lidar"])
@pytest.mark.parametrize("augment", [False, True])
def test_loader_batches_equal(net_type, augment):
    """Three batches (the sampler crosses an epoch: 5 frames, batches of 2)
    from equal seeds; the lidar raster of the port (the voxelizer's twin)
    against the JAX loader's: height and density equal, meta within 1e-5."""
    overrides = ("NET_TYPE", net_type, "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)",
                 "STATIC.MAX_POINTS", "9000", "STATIC.MAX_GT", "8")
    jc = j_config.cfg_from_list(j_config.default_config(), overrides)
    tc = t_config.cfg_from_list(t_config.default_config(), overrides)
    jd = j_synth.SyntheticDataset(jc, num_frames=5, image_hw=(64, 96))
    td = t_synth.SyntheticDataset(tc, num_frames=5, image_hw=(64, 96))
    # the JAX loader rasterizes with jax; built here without it, then rasterized
    jl = j_loader.BatchLoader(jd, jc, batch_size=2, augment=augment, seed=11, rasterize=False)
    tl = t_loader.BatchLoader(td, tc, batch_size=2, device="cpu", augment=augment, seed=11)
    raster = _jax_raster(jc) if net_type == "lidar" else None
    s = jc.lidar.num_slices
    for _ in range(3):
        want, got = jl.next(), tl.next()
        if raster is not None:
            want["data"] = np.asarray(raster(jnp.asarray(want.pop("points")),
                                             jnp.asarray(want.pop("point_valid"))))
            data = got["data"].numpy()
            assert data.shape == want["data"].shape == (2, 200, 175, 15)
            np.testing.assert_array_equal(data[..., :s + 1], want["data"][..., :s + 1])
            np.testing.assert_allclose(data[..., s + 1:], want["data"][..., s + 1:], atol=1e-5)
            assert tl.last_raster_ms is not None
        else:
            np.testing.assert_array_equal(got["data"], want["data"])
        assert got.keys() == want.keys()
        for k in want:
            if k != "data":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_loader_refuses_what_is_not_ported():
    cfg = t_config.cfg_from_list(t_config.default_config(), ("NET_TYPE", "image"))
    db = t_synth.SyntheticDataset(cfg, num_frames=2, image_hw=(32, 32))
    with pytest.raises(NotImplementedError):
        t_loader.BatchLoader(db, cfg, 2, device="cpu", workers=2)
    loader = t_loader.BatchLoader(db, cfg, 2, device="cpu")
    with pytest.raises(NotImplementedError):
        loader.start()


def _eval_case(eval_type, rng):
    """Detections near and far from the GT of 4 frames, with duplicates,
    an empty frame and a detection on a frame without GT."""
    gt_frames, dets = {}, []
    for f in range(4):
        n = 0 if f == 3 else rng.randint(1, 5)
        if eval_type == "2d":
            xy = rng.uniform(0, 200, (n, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(10, 60, (n, 2))], 1)
        else:
            boxes = np.stack([rng.uniform(0, 300, n), rng.uniform(0, 300, n), rng.uniform(0, 3, n),
                              rng.uniform(15, 25, n), rng.uniform(7, 11, n), rng.uniform(1, 2, n),
                              rng.uniform(-np.pi, np.pi, n)], 1)
        gt_frames[f"f{f}"] = {"boxes": boxes}
        for b in boxes:
            for _ in range(rng.randint(0, 3)):
                jitter = b + rng.normal(0, 1.0, b.shape) * (0.3 if eval_type != "2d" else 2.0)
                dets.append({"frame_id": f"f{f}", "bbox": jitter, "confidence": rng.uniform()})
    dets.append({"frame_id": "f3", "bbox": dets[0]["bbox"], "confidence": 0.99})
    return dets, gt_frames


@pytest.mark.parametrize("eval_type", ["2d", "bev", "3d", "bev_aa"])
def test_evaluate_class_equals_the_jax_eval(eval_type):
    rng = np.random.RandomState({"2d": 0, "bev": 1, "3d": 2, "bev_aa": 3}[eval_type])
    dets, gt_frames = _eval_case(eval_type, rng)
    for thresh in (0.3, 0.5, 0.7):
        want = j_eval.evaluate_class(dets, gt_frames, iou_thresh=thresh, eval_type=eval_type)
        got = t_eval.evaluate_class(dets, gt_frames, iou_thresh=thresh, eval_type=eval_type)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0 < want["tp"] < len(dets)
