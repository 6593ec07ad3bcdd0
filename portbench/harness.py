"""One run of one cell: set-up, the measured window, the traced stretch, and
the comparison that decides `correct`.

The system under test is the port, `faster_rcnn_pytorch_multimodal_tpu_torch`:
  training  `training.solver.train` (H2D copy, `draw_train_keys`, forward,
            backward, `DetectorSGD`, the losses read back each step) fed by a
            pool of batches; LiDAR batches are rasterized by the port's
            `ops.voxelize.voxelize_bev` as each is handed out, as the port's
            loader does.  Set-up builds the model and optimizer and runs the
            first SETUP_STEPS steps through the same call; the window goes
            on with the same objects.
  serving   `inference.detect_batch` then `inference.filter_batch`, the
            filtered detections copied to the host (LiDAR: `voxelize_bev`
            first), one batch after the other (closed loop).
The benchmark makes the weights and the inputs from the seed and hands the
same to the program and to the reference.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import cells, judge, trace, traffic, yardstick
from portbench.reference.config import reference_config
from portbench.reference.model import Detector, make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "faster_rcnn_pytorch_multimodal_tpu")
PROGRAM = "faster_rcnn_pytorch_multimodal_tpu_torch"


def forbidden_modules(modules) -> List[str]:
    """Top-level names among `modules` that no run may load."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def frame_config(cell: cells.Cell, det: Detector) -> dict:
    """The frame kind and sizes the traffic generator needs."""
    c = det.cfg
    if det.lidar:
        grid = det.raster_grid()
        return {"kind": "lidar", "max_gt": c["STATIC.MAX_GT"], "max_points": c["STATIC.MAX_POINTS"],
                "x_range": c["LIDAR.X_RANGE"], "y_range": c["LIDAR.Y_RANGE"],
                "z_range": c["LIDAR.Z_RANGE"], "raster_xy": (grid["num_x"], grid["num_y"])}
    return {"kind": "image", "max_gt": c["STATIC.MAX_GT"], "frame_hw": cell.config["frame_hw"]}


def program_config(cell: cells.Cell):
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config

    return cfg_from_list(default_config(), tuple(cell.config["overrides"]))


def program_model(cfg, num_classes: int, weights: Dict[str, torch.Tensor], device):
    """The port's detector with the benchmark's weights: built on the meta
    device, its storage allocated on `device`, every parameter and buffer
    loaded (strict)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import FasterRCNN

    with torch.device("meta"):
        model = FasterRCNN(cfg, num_classes)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


class Stopwatch:
    """The window's clock and, with tracing, the profiled stretch inside it:
    torch.profiler from the end of step `first` to the end of step
    `first + count`, with a span over the stretch."""

    def __init__(self, seconds: float, trace_steps: int, trace_after: float):
        self.seconds, self.trace_steps, self.trace_after = seconds, trace_steps, trace_after
        self.t0 = self.t1 = None
        self.prof = self.span = self.done = None
        self.profiled = 0

    def start(self):
        self.t0 = time.perf_counter()

    def tick(self) -> bool:
        """After a step or batch: whether the window is over."""
        now = time.perf_counter()
        if self.trace_steps:
            if self.prof is None and self.done is None and now - self.t0 >= self.trace_after:
                self._trace_start()
            elif self.prof is not None:
                self.profiled += 1
                if self.profiled == self.trace_steps:
                    self._trace_stop()
        if now - self.t0 >= self.seconds and self.prof is None:
            self.t1 = now
            return True
        return False

    def _trace_start(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.span = torch.autograd.profiler.record_function(trace.WINDOW)
        self.span.__enter__()

    def _trace_stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.done, self.prof = self.prof, None

    def read(self) -> dict:
        """The profiled stretch's summary, read once the window is over."""
        events = self.done.events()
        win = next(e for e in events if e.name == trace.WINDOW
                   and e.device_type.name == "CPU").time_range
        return trace.summarize(events, (win.start, win.end))


class PoolFeed:
    """The training loop's loader: the pool's batches in turn; a LiDAR batch's
    points go up to the device and through the port's voxelize_bev."""

    def __init__(self, pool: List[dict], device, raster: Optional[dict]):
        self.pool, self.device, self.raster = pool, device, raster
        self.i = 0
        self.last_raster = None

    def next(self) -> Dict[str, object]:
        from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import voxelize_bev

        with torch.autograd.profiler.record_function("portbench.feed"):
            b = self.pool[self.i % len(self.pool)]
            self.i += 1
            out = {k: b[k] for k in ("gt_boxes", "gt_mask", "window")}
            if self.raster is not None:
                pts = b["points"].to(self.device, non_blocking=True)
                valid = b["point_valid"].to(self.device, non_blocking=True)
                out["data"] = self.last_raster = voxelize_bev(pts, valid, **self.raster)
            else:
                out["data"] = b["data"]
            return out


PROPOSE = "models.detector.propose"


@contextlib.contextmanager
def recording_proposals(into: list, armed: Callable[[], bool] = lambda: True):
    """Within the block, each call of the port's proposal layer
    (`models.detector.propose`, looked up in its module at each call) made
    while `armed()` appends what it saw and chose to `into` (host copies),
    for the comparison after the window.  The benchmark depends on that name
    and call (PERF.md, Open questions): where the port stops calling it, the
    comparison finds nothing recorded and the run reads not correct."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector

    propose = detector.propose

    def recorded(fg, deltas, anchors, window, **kw):
        rois, scores, valid, src = propose(fg, deltas, anchors, window, **kw)
        if armed():
            into.append({k: v.detach().cpu() for k, v in (
                ("fg", fg), ("deltas", deltas), ("window", window), ("rois", rois),
                ("scores", scores), ("valid", valid), ("src", src))})
        return rois, scores, valid, src

    detector.propose = recorded
    try:
        yield into
    finally:
        detector.propose = propose


def run_train(cell, cfg, weights, pool, seed, watch: Stopwatch, device) -> dict:
    """Set-up steps then the window, through the port's training loop."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import check_supported
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD

    check_supported(cfg, training=True)
    model = program_model(cfg, cell.config["num_classes"], weights, device)
    model = model.to(memory_format=torch.channels_last).train()
    opt = DetectorSGD(model, cfg)
    raster = raster_kwargs(cfg, float(cfg.train.scales[0])) if cfg.net_type == "lidar" else None
    feed = PoolFeed(pool, device, raster)
    rec = {"proposals": [], "rasters": []}
    names = dict(zip(opt.params, opt.names))

    def setup_step(i, losses, ms):
        if raster is not None:
            rec["rasters"].append(feed.last_raster.cpu())
        if i == 0:
            norms = {}
            for group in opt.sgd.param_groups:
                for p in group["params"]:
                    buf = opt.sgd.state.get(p, {}).get("momentum_buffer")
                    k = names[p]
                    g = (torch.zeros_like(p) if buf is None
                         else buf - group["weight_decay"] * weights[k])
                    norms[k] = float(g.norm())
            rec["grad_norms"] = norms
            rec["change1_norms"] = {k: float((p.detach() - weights[k]).norm())
                                    for p, k in zip(opt.params, opt.names)}
        return False

    with recording_proposals(rec["proposals"]):
        first = solver.train(model, opt, feed, judge.SETUP_STEPS, gen(seed, device),
                             on_step=setup_step)
    rec["losses"] = first["losses"]
    rec["change_norms"] = {k: float((p.detach() - weights[k]).norm())
                           for p, k in zip(opt.params, opt.names)}
    weights.clear()
    steps = {"done": 0, "bad": 0}

    def window_step(i, losses, ms):
        steps["done"] += 1
        steps["bad"] += not all(np.isfinite(v) for v in losses.values())
        return watch.tick()

    watch.start()
    solver.train(model, opt, feed, 10 ** 9, gen(seed, device), on_step=window_step,
                 first_step=judge.SETUP_STEPS)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    b = cell.traffic["batch"]
    return {"record": rec, "frames": steps["done"] * b, "failed": steps["bad"] * b,
            "rates": {"train_frames_per_s": steps["done"] * b / (watch.t1 - watch.t0)}}


def gen(seed: int, device) -> Callable[[int], torch.Generator]:
    return lambda step: judge.step_generator(seed, step, device)


def run_serve(cell, cfg, weights, pool, seed, watch: Stopwatch, device) -> dict:
    """Warm-up batches then the window, through the port's serving calls."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import detect_batch, filter_batch
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import check_supported, to_device
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev

    check_supported(cfg)
    model = to_device(program_model(cfg, cell.config["num_classes"], weights, device), device)
    weights.clear()
    raster = raster_kwargs(cfg, float(cfg.train.scales[0])) if cfg.net_type == "lidar" else None
    thresh = cfg.test.thresh

    def one(b):
        with torch.autograd.profiler.record_function("portbench.batch"):
            t = time.perf_counter()
            data = b["data"] if raster is None else voxelize_bev(
                b["points"].to(device, non_blocking=True),
                b["point_valid"].to(device, non_blocking=True), **raster)
            out = detect_batch(model, {"data": data, "window": b["window"]})
            host = {k: v.cpu() for k, v in filter_batch(model, out, thresh).items()}
            return time.perf_counter() - t, data, out, host

    mix = cell.traffic
    picks = judge.sample_ordinals(seed, mix["sample_from"], mix["samples"])
    rec, props, armed = {"batches": []}, [], [False]
    lat, hosts = [], []
    with recording_proposals(props, lambda: armed[0]):
        for i in range(mix["warmup"]):
            _, data, _, _ = one(pool[i % len(pool)])
            if i == 0 and raster is not None:
                rec["raster"] = data.cpu()
        watch.start()
        n, window_n = 0, None
        # a window shorter than the sample's range serves on, untimed, to its last pick
        while window_n is None or n <= picks[-1]:
            armed[0] = n in picks
            props.clear()
            dt, _, out, host = one(pool[n % len(pool)])
            if armed[0]:
                rec["batches"].append((n % len(pool), out, host,
                                       props[0] if len(props) == 1 else None))
            if window_n is None:
                lat.append(dt)
                hosts.append(host)
            n += 1
            if window_n is None and watch.tick():
                window_n = n
        armed[0] = False
    b = mix["batch"]
    bad = sum(any(not torch.isfinite(v).all() for v in h.values() if v.is_floating_point())
              for h in hosts)
    print(f"serve_batch_ms_p95: {len(lat)} batches in the window", file=sys.stderr, flush=True)
    return {"record": rec, "frames": window_n * b, "failed": bad * b,
            "rates": {"serve_frames_per_s": window_n * b / (watch.t1 - watch.t0),
                      "serve_batch_ms_p95": float(np.percentile(np.asarray(lat) * 1e3, 95))}}


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             root=cells.ROOT) -> dict:
    """One run: returns the result line's object and the compared numbers
    with their limits (the last key)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rcfg = reference_config(cell.config["overrides"])
    det = Detector(rcfg, cell.config["num_classes"], dev)
    cfg = program_config(cell)
    t = cell.traffic
    serve = t["path"] == "serve"
    pool = traffic.make_pool(t, frame_config(cell, det), seed, dev, pin=on_card)
    weights = make_weights(det.arch, seed, dev)
    if serve:  # the served dtype's values, for the reference too
        served = {"bfloat16": torch.bfloat16, "float32": torch.float32}[rcfg["COMPUTE_DTYPE"]]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    watch = Stopwatch(seconds, t["trace_steps"] if traced else 0, t["trace_after_s"])
    run = (run_serve if serve else run_train)(cell, cfg, weights, pool, seed, watch, dev)
    setup_s = watch.t0 + (time.time() - time.perf_counter()) - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    values = dict(run["rates"], setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": run["frames"], "failed": run["failed"]}
    if traced:
        if not yardstick.on_card(kind):
            print(f"portbench: the peaks are the {yardstick.CARD}'s; on {kind} the shares of "
                  "a peak or a roofline are left out", file=sys.stderr)
        s = watch.read()
        ctx = {"trace": s, "cell": cell, "rcfg": rcfg, "arch": det.arch, "kind": kind,
               "frames": t["trace_steps"] * t["batch"],
               "frames_per_s": values[f"{t['path']}_frames_per_s"], "hw": _frame_hw(det, cell)}
        result["metrics"] = cells.read_metrics(cell, ctx, root)
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in s["device_ops"]],
                               "idle_gaps": [list(x) for x in s["idle_gaps"]]}
    else:
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device_info
    # the reference runs after the window, with the program's model and optimizer freed
    if on_card:
        torch.cuda.empty_cache()
    try:
        if serve:
            nums = judge.judge_serve(det, pool, seed, dev, served, run["record"])
        else:
            nums = judge.judge_train(det, pool, seed, dev, run["record"])
    except (RuntimeError, ValueError, IndexError, KeyError) as e:
        # outputs the reference cannot even read (wrong shapes, missing parts)
        print(f"portbench: the outputs could not be judged: {e!r}", file=sys.stderr)
        nums = {k: float("inf") for k in cell.limits}
    unknown = sorted(set(cell.limits) - set(nums))
    if unknown:
        raise KeyError(f"portbench/limits/{cell.name}.json limits numbers never computed: "
                       f"{unknown}")
    checks = {k: {"value": nums[k], "limit": v} for k, v in cell.limits.items()}
    result["correct"] = bool(run["failed"] == 0 and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    return result


def _frame_hw(det: Detector, cell) -> tuple:
    if det.lidar:
        g = det.raster_grid()
        return (g["num_y"], g["num_x"])
    return tuple(cell.config["frame_hw"])
