#!/usr/bin/env python
"""Detection-quality runs of the PyTorch port (synthetic, fixed seed) -> JSON.

The port's copy of tools/quality_run.py: the same recipes (`build_cfg`),
flags (`build_parser`), metrics and suite (`emit_suite`), run through the
port on one device.  A leg trains res18 from scratch (RESNET.FIXED_BLOCKS
-1: live BN, zero-init residual terminators) in the config's compute dtype
(bfloat16 by default) and evaluates through the serving path:
forward_test in eval mode on the running statistics -> filter_detections
-> to_per_class_lists -> evaluate_class.  Every eval records detection mAP
@ 0.5 (2d for images, 3d and BEV for lidar), class-agnostic RPN proposal
recall @ 0.5, and a false-positive taxonomy (duplicate / localization /
background), and the run's JSON is written again after each eval, so a leg
cut short still leaves its curve.  With --uc (class and box aleatoric and
epistemic uncertainty, the image_uc_scratch leg) each eval also records
`uc_stats`: for a_entropy and e_mutual_info the mean over the true and the
false positives and the share of (FP, TP) pairs where the FP carries the
higher value (auc_fp_ranked_higher), as tools/quality_run.py does; each
eval's MC masks and normals come from a generator seeded 0, as the JAX tool
serves with a fixed key.

    python tools/quality_run_torch.py --mode image --overfit --iters 200 --eval_every 100 --lr 0.01 --out chiprun_out/quality/image_overfit.json
    python tools/quality_run_torch.py --emit chiprun_out/quality/QUALITY_torch.json
    python tools/quality_run_torch.py --emit chiprun_out/quality/QUALITY_torch.json --legs image_overfit bev_overfit
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def build_cfg(mode: str, net: str, lr: float, overfit: bool, stepsize=None,
              fpn: bool = False, uc: bool = False):
    """The leg's config, override for override tools/quality_run.py's."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config

    common = (
        "NET_VARIANT", net,
        "RESNET.FIXED_BLOCKS", "-1",  # from scratch: live BN
        "TRAIN.LEARNING_RATE", str(lr),
        "TRAIN.SNAPSHOT_ITERS", "1000000",  # no snapshots in quality runs
    )
    if fpn:
        common += ("USE_FPN", "True", "POOLING_MODE", "multiscale")
    if uc:
        common += (
            "UC.EN_CLS_ALEATORIC", "True", "UC.EN_BBOX_ALEATORIC", "True",
            "UC.EN_CLS_EPISTEMIC", "True", "UC.EN_BBOX_EPISTEMIC", "True",
        )
    # applied last, so it beats the image recipe's default stepsize
    tail = (("TRAIN.STEPSIZE", "(" + ",".join(str(s) for s in stepsize) + ",)")
            if stepsize else ())
    if overfit:
        # the frozen frame is frame 0, the one the eval scores
        common += ("DEBUG.FREEZE_DB", "True", "DEBUG.FREEZE_DB_INDS", "0")
    if mode == "bev":
        return cfg_from_list(
            default_config(),
            ("NET_TYPE", "lidar") + common + (
                "TRAIN.SCALES", "(0.5,)",
                "TEST.SCALES", "(0.5,)",
                "TRAIN.RPN_POST_NMS_TOP_N", "512",
                "TEST.RPN_POST_NMS_TOP_N", "300",
                "STATIC.NMS_PRE_TRAIN", "1024",
                "STATIC.NMS_PRE_TEST", "1024",
                "STATIC.MAX_GT", "16",
                "STATIC.MAX_POINTS", "16384",
                "LIDAR.ANCHOR_SUBSTRIDE", "4",
                "LIDAR.RPN_POSITIVE_OVERLAP", "0.45",
                "LIDAR.RPN_NEGATIVE_OVERLAP", "0.3",
            ) + tail,
        )
    return cfg_from_list(
        default_config(),
        ("NET_TYPE", "image") + common + (
            "PIXEL_STDDEVS", "[60.,60.,60.]",
            "TRAIN.SCALES", "(1.0,)",
            "TEST.SCALES", "(1.0,)",
            "TRAIN.RPN_POST_NMS_TOP_N", "512",
            "TEST.RPN_POST_NMS_TOP_N", "300",
            "STATIC.NMS_PRE_TRAIN", "2048",
            "STATIC.NMS_PRE_TEST", "2048",
            "STATIC.MAX_GT", "16",
            "ANCHOR_SCALES", "[2,4,8,16]",
            # the synthetic boxes' aspect ratios reach ~1:6
            "ANCHOR_RATIOS", "[0.33,0.5,1,2,3]",
            "TRAIN.STEPSIZE", "(2500,)",
        ) + tail,
    )


def fp_taxonomy(fps: list, gt_frames: dict, iou_fn, thresh: float) -> dict:
    """Classify false positives: duplicate (IoU >= thresh with an already
    matched GT), localization (0.1 <= IoU < thresh), background (IoU < 0.1,
    or a frame without GT)."""
    out = {"duplicate": 0, "localization": 0, "background": 0}
    for det in fps:
        g = gt_frames.get(det["frame_id"])
        if g is None or len(g["boxes"]) == 0:
            out["background"] += 1
            continue
        best = float(np.max(iou_fn(g["boxes"], det["bbox"])))
        if best >= thresh:
            out["duplicate"] += 1
        elif best >= 0.1:
            out["localization"] += 1
        else:
            out["background"] += 1
    return out


UC_KEYS = ("a_entropy", "e_mutual_info")


def uc_separation(detections: list, fps: list) -> dict:
    """Whether the reported uncertainty ranks false positives above true
    positives: per key of UC_KEYS the TP and FP means and the Mann-Whitney
    share of (FP, TP) pairs with the FP higher (ties count half), as
    tools/quality_run.py computes them.  Empty without uncertainty rows."""
    out = {}
    fp_ids = {id(d) for d in fps}
    for key in UC_KEYS:
        if not (detections and key in detections[0]):
            continue
        fp_v = np.array([d[key] for d in detections if id(d) in fp_ids])
        tp_v = np.array([d[key] for d in detections if id(d) not in fp_ids])
        if len(fp_v) == 0 or len(tp_v) == 0:
            continue
        gt_cnt = (fp_v[None, :] > tp_v[:, None]).sum()
        eq_cnt = (fp_v[None, :] == tp_v[:, None]).sum()
        out[key] = {
            "tp_mean": round(float(tp_v.mean()), 5),
            "fp_mean": round(float(fp_v.mean()), 5),
            "auc_fp_ranked_higher": round(
                float((gt_cnt + 0.5 * eq_cnt) / (len(fp_v) * len(tp_v))), 4),
        }
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["image", "bev"], default="image")
    ap.add_argument("--net", default="res18")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.004)
    ap.add_argument("--thresh", type=float, default=0.05)
    ap.add_argument("--overfit", action="store_true")
    ap.add_argument("--stepsize", type=int, nargs="*", default=None,
                    help="TRAIN.STEPSIZE boundaries for LR step decay")
    ap.add_argument("--rotated_nms", action="store_true",
                    help="bev: TEST.ROTATED_NMS at 0.3")
    ap.add_argument("--fpn", action="store_true", help="USE_FPN + multiscale RoIAlign")
    ap.add_argument("--uc", action="store_true",
                    help="cls+bbox aleatoric AND epistemic uncertainty (uc_stats per eval)")
    ap.add_argument("--rpn_pos", type=float, default=None,
                    help="TRAIN.RPN_POSITIVE_OVERLAP override")
    ap.add_argument("--rpn_neg", type=float, default=None,
                    help="TRAIN.RPN_NEGATIVE_OVERLAP override")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the run JSON here")
    ap.add_argument("--emit", default=None,
                    help="run the fixed suite and write this artifact")
    ap.add_argument("--legs", nargs="*", default=None,
                    help="with --emit: only these legs of the suite, in its order")
    ap.add_argument("--image_hw", type=int, nargs=2, default=(512, 960),
                    help="synthetic image frame size (image mode)")
    ap.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                    help="config overrides after the recipe's (small CPU runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CUDA kernels run only on 'cuda'")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.emit:
        return emit_suite(args.emit, args.device, args.legs)
    result = run_one(args)
    if args.out:
        print(f"wrote {args.out}")
    return result


def leg_config(args):
    """build_cfg plus the flags' overrides, in tools/quality_run.py's order,
    then --set."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list

    cfg = build_cfg(args.mode, args.net, args.lr, args.overfit, args.stepsize,
                    fpn=args.fpn, uc=args.uc)
    if args.rpn_pos is not None:
        cfg = cfg_from_list(cfg, ("TRAIN.RPN_POSITIVE_OVERLAP", str(args.rpn_pos)))
    if args.rpn_neg is not None:
        cfg = cfg_from_list(cfg, ("TRAIN.RPN_NEGATIVE_OVERLAP", str(args.rpn_neg)))
    if args.rotated_nms:
        cfg = cfg_from_list(cfg, ("TEST.ROTATED_NMS", "True", "TEST.NMS_THRESH", "0.3"))
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, tuple(args.set_cfgs))
    return cfg


def _write(path, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run_one(args) -> dict:
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
        evaluate_class,
        iou as eval_iou,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import UCDraws
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (
        filter_detections,
        to_per_class_lists,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import (
        bbox_3d_to_bev_aabb,
        bbox_overlaps,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        batch_to_device,
        create_train_state,
        detect,
        draw_train_keys,
        make_train_step,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer

    cfg = leg_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quality_run_torch: --device cuda but no CUDA device is visible")
    is_lidar = cfg.net_type == "lidar"
    bbox_elem = cfg.num_bbox_elem
    eval_type = "3d" if is_lidar else "2d"
    iou_t = 0.5

    ds_kwargs = dict(num_classes=2, seed=args.seed)
    if not is_lidar:
        ds_kwargs["image_hw"] = tuple(args.image_hw)
    n_frames = 1 if args.overfit else args.frames
    ds = SyntheticDataset(cfg, num_frames=max(n_frames, args.batch_size), **ds_kwargs)
    loader = BatchLoader(ds, cfg, batch_size=args.batch_size, device=device, seed=args.seed,
                         augment=False)
    val_loader = BatchLoader(ds, cfg, batch_size=args.batch_size, device=device, augment=False,
                             shuffle=False, seed=args.seed)

    model, optimizer = create_train_state(cfg, 2, device, seed=args.seed)
    step = make_train_step(model, optimizer)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    timer = DeviceTimer(device)

    # fixed val set: every dataset frame once (network space, un-augmented)
    n_eval = 1 if args.overfit else len(ds)
    gt_frames, gt_bev_frames = {}, {}
    for i in range(n_eval):
        gt = ds.frame(i, augment=False)["gt_boxes"]
        sel = gt[:, -1].astype(int) == 1
        gt_frames[f"frame_{i:06d}"] = {"boxes": gt[sel, :bbox_elem]}
        if is_lidar:
            gt_bev_frames[f"frame_{i:06d}"] = bbox_3d_to_bev_aabb(
                torch.from_numpy(np.ascontiguousarray(gt[sel, :7]))).numpy()

    def evaluate() -> dict:
        detections = []
        prop_hits = prop_total = 0
        val_loader._cur, val_loader._peeked = 0, None
        val_loader._perm = np.arange(len(ds))
        idx = 0
        while idx < n_eval:
            batch = batch_to_device(val_loader.next(), device)
            draws = UCDraws(torch.Generator(device=device).manual_seed(0)) if args.uc else None
            out = detect(model, batch["data"], batch["window"], draws)
            filt = filter_detections(
                out["cls_prob"], out["bbox_pred"], out["roi_valid"], num_classes=2,
                bbox_elem=bbox_elem, max_dets=cfg.test.max_dets, thresh=args.thresh,
                nms_thresh=cfg.test.nms_thresh, is_lidar=is_lidar,
                rotated_nms=cfg.test.rotated_nms,
            )
            filt = {k: v.cpu().numpy() for k, v in filt.items()}
            # each detection's uncertainty through the same (src, keep)
            # gather as its box (ops/filter.py to_per_class_lists)
            unc = {k: out["uncertainties"][k].cpu().numpy() for k in UC_KEYS} if args.uc else {}
            rois_all = out["rois"].cpu()
            for i in range(batch["window"].shape[0]):
                if idx >= n_eval:
                    break
                fid = f"frame_{idx:06d}"
                # proposal recall @ 0.5 (class-agnostic, BEV AABB for lidar)
                gtb = gt_bev_frames[fid] if is_lidar else gt_frames[fid]["boxes"]
                if len(gtb):
                    ious = bbox_overlaps(rois_all[i], torch.from_numpy(
                        np.ascontiguousarray(gtb, np.float32))).numpy()
                    prop_hits += int((ious.max(axis=0) >= 0.5).sum())
                    prop_total += len(gtb)
                boxes_j, uc_j = to_per_class_lists({k: v[i] for k, v in filt.items()},
                                                   {k: v[i] for k, v in unc.items()}, 2, bbox_elem)
                for r_i, row in enumerate(boxes_j[1]):
                    det = {"frame_id": fid, "bbox": row[:bbox_elem], "confidence": row[-1]}
                    for key in unc:
                        det[key] = float(uc_j[1][key][r_i, 0])
                    detections.append(det)
                idx += 1
        res = evaluate_class(detections, gt_frames, iou_thresh=iou_t, eval_type=eval_type)
        res_bev = (evaluate_class(detections, gt_frames, iou_thresh=iou_t, eval_type="bev")
                   if is_lidar else None)
        # the matcher's bookkeeping again, for the false positives
        order = sorted(detections, key=lambda d: -d["confidence"])
        matched = {fid: np.zeros(len(g["boxes"]), bool) for fid, g in gt_frames.items()}
        fps = []
        for det in order:
            g = gt_frames.get(det["frame_id"])
            if g is None or len(g["boxes"]) == 0:
                fps.append(det)
                continue
            ious = eval_iou(g["boxes"], det["bbox"], eval_type)
            j = int(np.argmax(ious))
            if ious[j] >= iou_t and not matched[det["frame_id"]][j]:
                matched[det["frame_id"]][j] = True
            else:
                fps.append(det)
        uc_stats = uc_separation(order, fps)
        out_d = {
            "map": float(res["ap"]), "tp": res["tp"], "fp": res["fp"], "npos": res["npos"],
            "proposal_recall": prop_hits / max(prop_total, 1),
            "fp_taxonomy": fp_taxonomy(fps, gt_frames,
                                       lambda b, d: eval_iou(b, d, eval_type), iou_t),
            "fp_conf50": int(sum(1 for d in fps if d["confidence"] >= 0.5)),
        }
        if res_bev is not None:
            out_d["map_bev"] = float(res_bev["ap"])
            out_d["tp_bev"] = res_bev["tp"]
        if uc_stats:
            out_d["uc_stats"] = uc_stats
        return out_d

    curve, step_ms = [], []
    t0 = time.time()
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    def result() -> dict:
        return {
            "mode": args.mode, "net": args.net, "frames": n_frames,
            "iters": args.iters, "lr": args.lr, "seed": args.seed,
            "overfit": bool(args.overfit),
            "rotated_nms": bool(cfg.test.rotated_nms),
            "eval": {"iou": iou_t, "type": eval_type, "thresh": args.thresh},
            "curve": curve,
            "final": curve[-1] if curve else None,
            "wall_sec": round(time.time() - t0, 1),
            "device": device_name, "compute_dtype": cfg.compute_dtype,
            "step_ms_median": float(np.median(step_ms)) if step_ms else None,
        }

    print(f"[quality_run_torch] mode={args.mode} net={args.net} frames={n_frames} "
          f"iters={args.iters} lr={args.lr} overfit={args.overfit} "
          f"rotated_nms={cfg.test.rotated_nms} device={device_name}", flush=True)
    window_losses = []
    for it in range(1, args.iters + 1):
        host = loader.next()
        timer.start()
        batch = batch_to_device(host, device)
        losses, _ = step(batch, draw_train_keys(model, batch, generator))
        step_ms.append(timer.stop())
        window_losses.append({k: float(v) for k, v in losses.items()})
        if it % args.eval_every == 0 or it == args.iters or it == 1:
            total = window_losses[-1]["total_loss"]
            ev = evaluate()
            # the losses of the steps since the last eval, averaged, beside
            # the last step's total (the JAX harness's total_loss)
            mean_losses = {k: round(float(np.mean([w[k] for w in window_losses])), 5)
                           for k in window_losses[-1]}
            ev.update(iter=it, total_loss=round(total, 4), mean_losses=mean_losses,
                      step_ms_median=float(np.median(step_ms[-len(window_losses):])))
            window_losses = []
            curve.append(ev)
            bev_s = f" mAP_bev={ev['map_bev']:.4f}" if "map_bev" in ev else ""
            print(f"  iter {it:5d} loss={total:.4f} mAP@{iou_t}({eval_type})="
                  f"{ev['map']:.4f}{bev_s} prop_recall={ev['proposal_recall']:.3f} "
                  f"tp={ev['tp']} fp={ev['fp']}/{ev['fp_taxonomy']} "
                  f"step {ev['step_ms_median']:.1f} ms [{time.time() - t0:.0f}s]", flush=True)
            if args.out:
                _write(args.out, result())
    return result()


SUITE = [
    ("image_overfit", ["--mode", "image", "--overfit", "--iters", "200",
                       "--eval_every", "100", "--lr", "0.01"]),
    ("image_scratch", ["--mode", "image", "--iters", "4000", "--eval_every", "500"]),
    ("bev_overfit", ["--mode", "bev", "--overfit", "--iters", "800",
                     "--eval_every", "200", "--lr", "0.01"]),
    ("bev_scratch_rotated", ["--mode", "bev", "--iters", "4000", "--eval_every", "500",
                             "--rotated_nms"]),
    ("bev_scratch_parity", ["--mode", "bev", "--iters", "4000", "--eval_every", "500"]),
    ("bev_scratch_long_rotated", ["--mode", "bev", "--iters", "12000", "--eval_every", "2000",
                                  "--rotated_nms", "--stepsize", "6000", "9000"]),
    ("image_scratch_tuned", ["--mode", "image", "--iters", "6000", "--eval_every", "1000",
                             "--rpn_pos", "0.5", "--rpn_neg", "0.3",
                             "--stepsize", "3000", "4500"]),
    ("fpn_scratch", ["--mode", "image", "--iters", "4000", "--eval_every", "500", "--fpn",
                     "--stepsize", "2500"]),
    ("image_uc_scratch", ["--mode", "image", "--iters", "4000", "--eval_every", "500", "--uc",
                          "--stepsize", "2500"]),
    ("image_scratch_long", ["--mode", "image", "--iters", "6000", "--eval_every", "1000",
                            "--stepsize", "3000", "4500"]),
]


def emit_suite(path: str, device: str = "cuda", legs=None) -> dict:
    """The fixed suite (tools/quality_run.py's legs, in its order, or the
    named `legs`) -> one artifact, written after every leg; legs already in
    it with a final entry are skipped.  Each leg runs in a process of its
    own; a leg that dies keeps the curve it wrote."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    for name, argv in SUITE:
        if legs is not None and name not in legs:
            continue
        if out.get(name, {}).get("final"):
            print(f"=== suite: {name} === already done, skipping")
            continue
        print(f"=== suite: {name} ===", flush=True)
        tmp = f"{path}.{name}.tmp"
        rc = _spawn_leg(argv + ["--device", device], tmp)
        if os.path.exists(tmp):
            with open(tmp) as f:
                out[name] = json.load(f)
            os.remove(tmp)
            if rc != 0:
                out[name]["error"] = f"subprocess rc {rc} (partial curve)"
        else:
            out[name] = {"error": f"subprocess rc {rc}", "mode": argv[1]}
        _write(path, out)
        print(f"updated {path} ({name} rc {rc})", flush=True)
    return out


def _spawn_leg(argv: list, tmp: str) -> int:
    """Run one suite leg as `python quality_run_torch.py <argv> --out tmp`."""
    import subprocess

    return subprocess.call([sys.executable, os.path.abspath(__file__), *argv, "--out", tmp])


if __name__ == "__main__":
    main()
