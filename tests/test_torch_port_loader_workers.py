"""The port's BatchLoader worker processes (`workers > 0`) against the serial
loader and against the JAX package's BatchLoader, on the CPU.

On the Waymo fixture tree of tests/test_datasets.py (LiDAR, every
augmentation switch on, so the native ops run in the workers), batches from
two spawned workers equal the serial loader's bit for bit, the raster
included (the voxelizer's twin on the CPU), and JAX's serial loader's on the
same seed: the host arrays bitwise, the raster against JAX's loader raster
(height and density equal, meta within 1e-5, as tests/test_torch_port_config.py
holds the loader).  The state_dict taken while the workers have run ahead
names the next batch next() has not handed out (JAX's serial state after as
many batches), kill() rewinds the sampler to it, and a resumed loader goes
on with the uninterrupted stream.  A worker that fails hands its exception
to next().  The workers start once in each test.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import loader as j_loader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data.datasets import get_db as j_get_db  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import bev_grid_size  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import voxelize_bev as j_voxelize  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list as t_cfg_from_list  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.config import default_config as t_default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data import loader as t_loader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import get_db as t_get_db  # noqa: E402
from tests.test_datasets import _make_waymo_tree  # noqa: E402

LIDAR = ("NET_TYPE", "lidar", "LIDAR.VOXEL_LEN", "0.5", "STATIC.MAX_POINTS", "1024",
         "STATIC.MAX_GT", "8", "LIDAR.EN_AUG_ROTATE", "True")
BATCH, SEED, PREFETCH = 2, 5, 2


def _setup(tmp_path, n_frames=5):
    root = _make_waymo_tree(str(tmp_path), n_frames=n_frames)
    base = ("DATA_DIR", root)
    jc = j_cfg_from_list(j_default_config(), base + LIDAR + ("CACHE_DIR", os.path.join(root, "cj")))
    tc = t_cfg_from_list(t_default_config(), base + LIDAR + ("CACHE_DIR", os.path.join(root, "ct")))
    return j_get_db("waymo", jc, "train"), t_get_db("waymo", tc, "train")


def _loader(db, **kw):
    return t_loader.BatchLoader(db, db.cfg, BATCH, device="cpu", seed=SEED, prefetch=PREFETCH,
                                **kw)


def _jax_raster(cfg):
    scale = float(cfg.train.scales[0])
    num_y, num_x, _ = bev_grid_size(cfg, scale)
    fn = partial(j_voxelize, x_range=cfg.lidar.x_range, y_range=cfg.lidar.y_range,
                 z_range=cfg.lidar.z_range, voxel_len=cfg.lidar.voxel_len / scale,
                 voxel_height=cfg.lidar.voxel_height, num_x=num_x, num_y=num_y,
                 num_slices=cfg.lidar.num_slices, num_meta=cfg.lidar.num_meta_channel,
                 max_pts_per_voxel=cfg.lidar.max_pts_per_voxel)
    return jax.jit(jax.vmap(fn))


def _same_batch(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), (what, k)


def _same_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _wait_ahead(loader, ahead, timeout=60.0):
    """Until the feeder has drawn `ahead` tasks past what next() handed out."""
    t0 = time.time()
    while len(loader._inflight) < ahead:
        assert time.time() - t0 < timeout, "the workers never ran ahead"
        time.sleep(0.01)


def test_worker_batches_equal_serial_and_jax(tmp_path):
    jdb, tdb = _setup(tmp_path)
    n = 6  # 12 frames of 5: the sampler crosses two epochs
    serial = _loader(tdb)
    want = [serial._build_batch(serial._sample_task()) for _ in range(n)]

    # JAX's loader on the same seed: its host arrays, and its raster from the
    # points it assembled
    jl = j_loader.BatchLoader(jdb, jdb.cfg, batch_size=BATCH, seed=SEED, rasterize=False)
    raster = _jax_raster(jdb.cfg)
    s = jdb.cfg.lidar.num_slices
    for i, w in enumerate(want):
        jb = jl.next()
        pts, valid = jb.pop("points"), jb.pop("point_valid")
        jdata = np.asarray(raster(pts, valid))
        data = w["data"].numpy()
        np.testing.assert_array_equal(data[..., :s + 1], jdata[..., :s + 1], err_msg=f"batch {i}")
        np.testing.assert_allclose(data[..., s + 1:], jdata[..., s + 1:], atol=1e-5)
        _same_batch({k: v for k, v in w.items() if k != "data"}, jb, f"JAX batch {i}")

    loader = _loader(tdb, workers=2)
    loader.start()
    try:
        got = [loader.next() for _ in range(2)]
        _wait_ahead(loader, PREFETCH)
        # the state of the next batch next() has not handed out: JAX's
        # serial loader's after two batches
        state = loader.state_dict()
        jl2 = j_loader.BatchLoader(jdb, jdb.cfg, batch_size=BATCH, seed=SEED, rasterize=False)
        for _ in range(2):
            jl2.next()
        _same_state(state, jl2.state_dict())
        got += [loader.next() for _ in range(2)]
        assert loader.last_raster_thread == "BatchLoader-collector"
    finally:
        loader.kill()
    for i, (g, w) in enumerate(zip(got, want)):
        _same_batch(g, w, f"worker batch {i}")
    assert not loader._procs and not any(p.is_alive() for p in loader._procs)

    # kill() rewound the sampler to batch 4: the loader goes on serially
    _same_batch(loader.next(), want[4], "after kill")
    # a new loader from the state taken while the workers ran ahead
    resumed = _loader(tdb)
    resumed.load_state_dict(state)
    for i in (2, 3, 4, 5):
        _same_batch(resumed.next(), want[i], f"resumed batch {i}")


def test_worker_failure_reaches_next(tmp_path):
    """A frame the worker cannot read: next() raises with its error."""
    _, tdb = _setup(tmp_path, n_frames=3)
    _ = tdb.roidb  # the roidb is built before the file goes
    os.remove(tdb.roidb[1]["filename"])
    loader = t_loader.BatchLoader(tdb, tdb.cfg, 3, device="cpu", seed=SEED, workers=1,
                                  shuffle=False)
    loader.start()
    try:
        with pytest.raises(RuntimeError, match="worker failed") as e:
            loader.next()
        assert isinstance(e.value.__cause__, FileNotFoundError)
    finally:
        loader.kill()
