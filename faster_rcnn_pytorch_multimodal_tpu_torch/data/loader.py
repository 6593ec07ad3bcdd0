"""Host batch loader: epoch iteration, padding, and the device-side raster.

A copy of what the port's paths use of the JAX package's
faster_rcnn_pytorch_multimodal_tpu/data/loader.py: `_assemble_batch`
(:28-140, without the multi-host row split) and the sampler `_new_perm`,
`_next_indices`, `_sample_task`, `peek` and `next` (:251-306), on the same
np.random.RandomState stream, so equal seeds give equal batches.

Outputs are padded to static shapes:
  image:  data (B, H, W, 3) uint8 numpy, padded with the mean pixel;
  lidar:  data (B, Y, X, slices + 3) float32 torch tensor on `device`: the
          host ships the raw points (B, P, 5) and point_valid (B, P) and
          `voxelize_bev` rasterizes them there, so the raster never visits
          the host (`_finalize`, as the JAX loader's :475-492);
  gt_boxes (B, G, 5|8), gt_mask (B, G), window (B, 4), gt_boxes_dc, dc_mask.

The raster's grid uses TRAIN.SCALES[0] even at test time, as the JAX loader
does (:453); serving configs set TRAIN.SCALES and TEST.SCALES alike.

Not ported yet: prefetch threads (`start`), worker processes, the sampler's
state_dict and the minibatch drawing; asking for the first two, or for
DEBUG.DRAW_MINIBATCH, raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer


def _assemble_batch(dataset, cfg: Config, augment: bool, task) -> Dict[str, np.ndarray]:
    """Numpy batch assembly from a sampled task (indices, seeds, scale_idx):
    each frame gets its own RandomState seeded from the task."""
    indices, seeds, scale_idx = task
    scale = (
        float(cfg.train.scales[scale_idx])
        if augment and cfg.net_type != "lidar"
        else None
    )
    frames = [
        dataset.frame(
            int(i), augment=augment, rng=np.random.RandomState(s), scale=scale
        )
        for i, s in zip(indices, seeds)
    ]
    g = cfg.static.max_gt
    n_elem = 8 if cfg.net_type == "lidar" else 5
    b = len(frames)

    gt = np.zeros((b, g, n_elem), np.float32)
    gt_mask = np.zeros((b, g), bool)
    window = np.zeros((b, 4), np.float32)
    for i, f in enumerate(frames):
        boxes = f["gt_boxes"][:g]
        gt[i, : len(boxes)] = boxes
        gt_mask[i, : len(boxes)] = True
        window[i] = f["window"]

    batch: Dict[str, np.ndarray] = {
        "gt_boxes": gt,
        "gt_mask": gt_mask,
        "window": window,
        "_indices": np.asarray(indices),
    }
    if augment and cfg.net_type != "lidar" and len(cfg.train.scales) > 1:
        batch["scale_idx"] = np.int32(scale_idx)

    # don't-care regions (always 4 columns) feed TRAIN.IGNORE_DC
    d = cfg.static.max_gt_dc
    dc = np.zeros((b, d, 4), np.float32)
    dc_mask = np.zeros((b, d), bool)
    for i, f in enumerate(frames):
        fdc = f.get("gt_boxes_dc")
        if fdc is not None and len(fdc):
            fdc = fdc[:d]
            dc[i, : len(fdc)] = fdc
            dc_mask[i, : len(fdc)] = True
    batch["gt_boxes_dc"] = dc
    batch["dc_mask"] = dc_mask

    if cfg.net_type == "lidar":
        p = cfg.static.max_points
        pts = np.zeros((b, p, 5), np.float32)
        pvalid = np.zeros((b, p), bool)
        for i, f in enumerate(frames):
            fp = f["points"][:p]
            pts[i, : len(fp)] = fp
            pvalid[i, : len(fp)] = True
        batch["points"] = pts
        batch["point_valid"] = pvalid
    else:
        # pad to the batch max rounded up to a 64-pixel bucket
        def _bucket(v: int) -> int:
            return ((v + 63) // 64) * 64

        h = _bucket(max(f["data"].shape[0] for f in frames))
        w = _bucket(max(f["data"].shape[1] for f in frames))
        dtype = frames[0]["data"].dtype
        nch = frames[0]["data"].shape[2]
        # uint8 frames pad with the mean pixel, which normalizes to zero
        if np.issubdtype(dtype, np.integer) and nch == len(cfg.pixel_means):
            fill = np.asarray(cfg.pixel_means, np.float32)
            data = np.broadcast_to(
                np.clip(np.round(fill), 0, 255).astype(dtype), (b, h, w, nch)
            ).copy()
        else:
            data = np.zeros((b, h, w, nch), dtype)
        for i, f in enumerate(frames):
            fh, fw = f["data"].shape[:2]
            data[i, :fh, :fw] = f["data"]
        batch["data"] = data
    return batch


class BatchLoader:
    """Batches of a dataset in sampler order; lidar rasters on `device`.

    device: where lidar batches are rasterized (required; image batches
    stay numpy on the host).  `last_raster_ms` holds the device time of the
    last batch's voxelize_bev call (CUDA events on a card)."""

    def __init__(
        self,
        dataset,
        cfg: Config,
        batch_size: int,
        *,
        device: torch.device | str,
        augment: bool = True,
        shuffle: bool = True,
        seed: int = 3,
        rasterize: bool = True,
        workers: int = 0,
    ):
        if workers > 0:
            raise NotImplementedError("BatchLoader: worker processes are not ported")
        if cfg.debug.draw_minibatch:
            raise NotImplementedError("BatchLoader: DEBUG.DRAW_MINIBATCH is not ported")
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.augment = augment
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._perm = self._new_perm()
        self._cur = 0
        self._epoch = 0
        self._peeked: Optional[Dict[str, np.ndarray]] = None
        self._grid = None
        if cfg.net_type == "lidar" and rasterize:
            self._grid = raster_kwargs(cfg, float(cfg.train.scales[0]))
        self._timer = DeviceTimer(self.device)
        self.last_raster_ms: Optional[float] = None

    # -- iteration -------------------------------------------------------

    def _new_perm(self) -> np.ndarray:
        n = len(self.dataset)
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    def _next_indices(self) -> np.ndarray:
        if self.cfg.debug.freeze_db:
            # pin the sampler to one frame (DEBUG.FREEZE_DB)
            idx = self.cfg.debug.freeze_db_inds % len(self.dataset)
            return np.full((self.batch_size,), idx, np.int64)
        out = []
        for _ in range(self.batch_size):
            if self._cur >= len(self._perm):
                self._perm = self._new_perm()
                self._cur = 0
                self._epoch += 1
            out.append(self._perm[self._cur])
            self._cur += 1
        return np.asarray(out)

    def _sample_task(self):
        """One batch's (indices, seeds, scale_idx) from the sampler rng."""
        indices = self._next_indices()
        scales = self.cfg.train.scales
        if self.augment and self.cfg.net_type != "lidar" and len(scales) > 1:
            scale_idx = int(self._rng.randint(len(scales)))
        else:
            scale_idx = 0
        seeds = [int(self._rng.randint(1 << 31)) for _ in indices]
        return np.asarray(indices), seeds, scale_idx

    def peek(self) -> Dict[str, object]:
        if self._peeked is None:
            self._peeked = self._build_batch(self._sample_task())
        return self._peeked

    def next(self) -> Dict[str, object]:
        if self._peeked is not None:
            b, self._peeked = self._peeked, None
            return b
        return self._build_batch(self._sample_task())

    def start(self, transfer=None):
        raise NotImplementedError("BatchLoader: background prefetch is not ported")

    # -- batch assembly ----------------------------------------------------

    def _build_batch(self, task) -> Dict[str, object]:
        return self._finalize(_assemble_batch(self.dataset, self.cfg, self.augment, task))

    def _finalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, object]:
        """The lidar raster on the device: points up, raster stays there."""
        batch.pop("_indices", None)
        if self._grid is not None and "points" in batch:
            points = torch.from_numpy(batch.pop("points")).to(self.device)
            valid = torch.from_numpy(batch.pop("point_valid")).to(self.device)
            self._timer.start()
            batch["data"] = voxelize_bev(points, valid, **self._grid)
            self.last_raster_ms = self._timer.stop()
        return batch
