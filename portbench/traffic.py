"""The general generator of the benchmark's inputs: a pool of distinct
batches made from `--seed` by the parameters of a traffic file.

Every seed gets the same sizes: the number of GT boxes a frame and (LiDAR)
the number of points a frame are fixed lists spread evenly over the traffic
file's ranges, handed to the frames in an order drawn from the seed; only
positions, shapes and values are drawn.  Frames are made on the device by
one generator in a few large calls and then held in pinned host memory, so
each step or batch copies its inputs up as a loader's batch would.

Camera frames: uint8 NHWC pixels and 2D GT boxes [x1, y1, x2, y2, cls].
LiDAR frames: points [x, y, z, intensity, elongation] of a spinning sensor
(ground returns denser near it, walls and vegetation up to 75 m, all
around; the sweep of the port's `chip_smoke.waymo_frame`), the points of
each vehicle box inside it, and 7-DoF GT [xc, yc, zc, l, w, h, ry, cls] in
the voxel grid's units, as the port's loader hands them to the detector.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.ops import seed_of


def _spread(lo: int, hi: int, n: int, rng: np.random.RandomState) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi], in an order drawn from rng."""
    return rng.permutation(np.round(np.linspace(lo, hi, n)).astype(np.int64))


def image_frames(p: dict, cfg: dict, n: int, gen, rng, device) -> Dict[str, torch.Tensor]:
    h, w = cfg["frame_hw"]
    g = cfg["max_gt"]
    counts = torch.from_numpy(_spread(*p["gt"], n, rng)).to(device)
    lo, hi = p["gt_side"]
    side = lo + (hi - lo) * torch.rand((n, g, 2), generator=gen, device=device)
    side = torch.minimum(side, torch.tensor([w - 2.0, h - 2.0], device=device))
    corner = torch.rand((n, g, 2), generator=gen, device=device) * (
        torch.tensor([w - 1.0, h - 1.0], device=device) - side)
    mask = torch.arange(g, device=device) < counts[:, None]
    boxes = torch.cat([corner, corner + side, torch.ones((n, g, 1), device=device)], 2)
    return {"data": torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                                  dtype=torch.uint8),
            "gt_boxes": torch.where(mask[..., None], boxes, 0.0), "gt_mask": mask,
            "window": torch.tensor([0.0, w, 0.0, h], device=device).expand(n, 4).contiguous()}


def lidar_frames(p: dict, cfg: dict, n: int, gen, rng, device) -> Dict[str, torch.Tensor]:
    g, cap = cfg["max_gt"], cfg["max_points"]
    xr, yr, zr = cfg["x_range"], cfg["y_range"], cfg["z_range"]
    num_x, num_y = cfg["raster_xy"]
    counts = torch.from_numpy(_spread(*p["gt"], n, rng)).to(device)
    npts = torch.from_numpy(_spread(*p["points"], n, rng)).to(device)
    if int(npts.max()) > cap:
        raise ValueError(f"traffic: {int(npts.max())} points a frame, STATIC.MAX_POINTS {cap}")

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    # vehicles: range 6-68 m ahead within +-0.9 rad, Waymo-sized, any heading
    r, az = u(n, g, lo=6.0, hi=68.0), u(n, g, lo=-0.9, hi=0.9)
    dims = torch.stack([u(n, g, lo=3.8, hi=5.6), u(n, g, lo=1.7, hi=2.2),
                        u(n, g, lo=1.4, hi=2.0)], 2)
    heading = u(n, g, lo=-math.pi, hi=math.pi)
    centre = torch.stack([r * torch.cos(az), r * torch.sin(az), dims[..., 2] / 2], 2)
    mask = torch.arange(g, device=device) < counts[:, None]
    # returns fall off with range
    per_box = torch.where(mask, (torch.clamp(9e4 / r ** 2, max=2500.0)
                                 * u(n, g, lo=0.05, hi=1.0)).floor(), 0.0).long()
    ends = torch.cumsum(per_box, 1)  # the box points lead each frame
    slot = torch.arange(cap, device=device).expand(n, cap)
    box_id = torch.searchsorted(ends, slot.contiguous(), right=True)  # == g: not a box point
    in_box = box_id < g
    bid = box_id.clamp(max=g - 1)

    def at(t):  # (n, g, ...) per box -> (n, cap, ...) per point
        return torch.gather(t, 1, bid.reshape(n, cap, *([1] * (t.dim() - 2))).expand(
            (n, cap) + t.shape[2:]))

    local = (u(n, cap, 3) - 0.5) * at(dims)
    c, s = torch.cos(at(heading)), torch.sin(at(heading))
    ctr = at(centre)
    box_xyz = torch.stack([local[..., 0] * c - local[..., 1] * s + ctr[..., 0],
                           local[..., 0] * s + local[..., 1] * c + ctr[..., 1],
                           local[..., 2] + ctr[..., 2]], 2)
    # the sweep: 70% ground rings (denser near the sensor), the rest up to 4 m high
    ground = u(n, cap) < 0.7
    rr = torch.where(ground, 2.5 + 72.5 * u(n, cap) ** 2, u(n, cap, lo=5.0, hi=75.0))
    aa = u(n, cap, lo=-math.pi, hi=math.pi)
    zz = torch.where(ground, 0.04 * torch.randn((n, cap), generator=gen, device=device),
                     u(n, cap, lo=0.0, hi=4.0))
    sweep_xyz = torch.stack([rr * torch.cos(aa), rr * torch.sin(aa), zz], 2)
    xyz = torch.where(in_box[..., None], box_xyz, sweep_xyz)
    points = torch.cat([xyz, u(n, cap, 1), u(n, cap, 1, hi=0.3)], 2)
    valid = slot < npts[:, None]
    points = torch.where(valid[..., None], points, 0.0)
    sx, sy = num_x / (xr[1] - xr[0]), num_y / (yr[1] - yr[0])
    gt = torch.cat([((centre[..., 0] - xr[0]) * sx)[..., None],
                    ((centre[..., 1] - yr[0]) * sy)[..., None],
                    (centre[..., 2] - zr[0])[..., None], (dims[..., 0] * sx)[..., None],
                    (dims[..., 1] * sy)[..., None], dims[..., 2:3], heading[..., None],
                    torch.ones((n, g, 1), device=device)], 2)
    return {"points": points, "point_valid": valid,
            "gt_boxes": torch.where(mask[..., None], gt, 0.0), "gt_mask": mask,
            "window": torch.tensor([0.0, num_x, 0.0, num_y], device=device).expand(n, 4)
            .contiguous()}


def make_pool(traffic: dict, frame_cfg: dict, seed: int, device,
              pin: bool = True) -> List[Dict[str, torch.Tensor]]:
    """traffic["pool"] batches of traffic["batch"] frames, in (pinned) host
    memory; frame_cfg (see cells.frame_config) gives the frame kind and sizes."""
    b, k = traffic["batch"], traffic["pool"]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 0x7AFF1C))
    rng = np.random.RandomState(seed_of(seed, 0x512E5) % 2 ** 32)
    kind = frame_cfg["kind"]
    make = lidar_frames if kind == "lidar" else image_frames
    frames = make(traffic[kind], frame_cfg, b * k, gen, rng, device)
    host = {}
    for key, v in frames.items():
        v = v.cpu()
        host[key] = v.pin_memory() if pin else v
    return [{key: v[i * b:(i + 1) * b] for key, v in host.items()} for i in range(k)]
