#!/usr/bin/env python
"""Where the time of one serving batch goes, on one NVIDIA GPU.

Runs the port's serving batch (chip_smoke.py's configurations: res101 bf16,
batch 8; the image path at 512x960, the LiDAR BEV path on 400 x 350 x 15
rasters of synthetic points) stage by stage, each stage timed with CUDA
events, the stages run one after another on the same batch, median of
--reps runs after a warm-up.  A stage's time includes the device waiting
for the host to launch its kernels.  Then torch.profiler over --reps whole
batches: kernels launched per batch, device busy share of the kernel span,
and the CUDA time by kernel name.

    python tools/stage_times_torch.py --net_type lidar
    python tools/stage_times_torch.py --net_type image --reps 5
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--net_type", default="lidar", choices=("lidar", "image"))
    parser.add_argument("--reps", default=5, type=int)
    parser.add_argument("--top", default=12, type=int, help="kernels listed by CUDA time")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    import chip_smoke as cs
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import detect_batch, filter_batch
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer

    if not torch.cuda.is_available():
        raise SystemExit("stage_times_torch: needs a CUDA device")
    lidar = args.net_type == "lidar"
    if lidar:
        cfg = cs.make_config(cs.BEV_OVERRIDES, cs.BEV_SERVING_OVERRIDES)
        db = SyntheticDataset(cfg, num_frames=cs.B, num_classes=2, mode="val", seed=101)
    else:
        cfg = cs.make_config(cs.IMAGE_OVERRIDES, cs.SERVING_OVERRIDES)
        db = SyntheticDataset(cfg, num_frames=cs.B, num_classes=2, image_hw=cs.FRAME_HW,
                              mode="val", seed=101)
    device = torch.device("cuda")
    loader = BatchLoader(db, cfg, batch_size=cs.B, device=device, augment=False, shuffle=False,
                         rasterize=False)
    batch = loader.next()
    model = cs.scale_terminators(build_detector(cfg, 2, device, seed=0))
    window = torch.from_numpy(batch["window"]).to(device)
    if lidar:
        points = torch.from_numpy(batch["points"]).to(device)
        valid = torch.from_numpy(batch["point_valid"]).to(device)
        grid = raster_kwargs(cfg, float(cfg.train.scales[0]))
        images = voxelize_bev(points, valid, **grid)
    else:
        images = torch.from_numpy(batch["data"]).to(device)

    timer = DeviceTimer(device)
    state = {}

    def stage_fns():
        m = model

        def raster():
            state["images"] = voxelize_bev(points, valid, **grid)

        def backbone():
            state["feat"] = m.features(images)

        def rpn():
            state["rpn"] = m.rpn_scores(state["feat"])

        def proposals():
            f = state["feat"]
            anchors, a3d = m.anchor_grids(f.shape[1], f.shape[2], device)
            rois, _s, ok, src = m._propose_batch(state["rpn"], anchors, window)
            state["rois"], state["ok"], state["a3d"] = rois, ok, a3d[src] if lidar else None

        def roi_align():
            state["pooled"] = m.pool_rois(state["feat"], state["rois"])

        def tail():
            r = state["rois"]
            state["det"] = m.pooled_head(state["pooled"], r.shape[0], r.shape[1])

        def decode_and_filter():
            out = {"roi_valid": state["ok"]}
            out["cls_prob"], out["bbox_pred"] = m.decode(
                state["det"], state["rois"], window, state["a3d"])
            filter_batch(m, out, cfg.test.thresh)

        stages = [("voxelize_bev", raster)] if lidar else []
        stages += [("backbone (stem + layer1-3)", backbone), ("RPN head", rpn),
                   ("proposals (decode, sort, NMS kernel, gathers)", proposals),
                   ("RoI align kernel", roi_align), ("tail (layer4, mean, predictors)", tail),
                   ("decode + final filter (NMS kernel)", decode_and_filter)]
        return stages

    def whole():
        b = dict(batch)
        b["data"] = voxelize_bev(points, valid, **grid) if lidar else images
        filter_batch(model, detect_batch(model, b), cfg.test.thresh)

    with torch.inference_mode():
        stages = stage_fns()
        for _, fn in stages:  # warm-up
            fn()
        whole()
        times = {name: [] for name, _ in stages}
        whole_ms = []
        for _ in range(args.reps):
            for name, fn in stages:
                timer.start()
                fn()
                times[name].append(timer.stop())
            timer.start()
            whole()
            whole_ms.append(timer.stop())
        smi = cs.smi_name_power()
        shape = tuple(images.shape)
        print(f"{cfg.net_variant} {cfg.compute_dtype} {args.net_type} input {shape} ({smi}); "
              f"median of {args.reps} runs, CUDA events:")
        for name, ms in times.items():
            print(f"  {name}: {float(np.median(ms))} ms")
        print(f"  sum of stages: {sum(float(np.median(v)) for v in times.values())} ms")
        print(f"  whole batch (voxelize + forward_test + filter): median "
              f"{float(np.median(whole_ms))} ms, runs {whole_ms}")

        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                whole()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not events:
        print("profiler: no device events recorded")
        return
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy = sum(e.time_range.end - e.time_range.start for e in events)
    print(f"profiler over {args.reps} batches: {len(events) / args.reps} kernels a batch, "
          f"{busy / 1e3 / args.reps} ms of kernel time a batch in a "
          f"{(end - start) / 1e3 / args.reps} ms span, busy {busy / max(end - start, 1)}")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + (e.time_range.end - e.time_range.start)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {us / busy:.4f} of CUDA time ({us / 1e3 / args.reps} ms a batch): {name[:110]}")


if __name__ == "__main__":
    main()
