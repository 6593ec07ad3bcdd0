"""The ranks' side of tests/test_torch_port_model_parallel.py: training steps
of the port on a (data 2 x model 2) mesh of spawned CPU ranks over gloo
(parallel.multihost.spawn_ranks), and the same steps in one process on the
global batch, for the test to hold against each other.  No JAX here: a
spawned rank imports this module.

The cases (tests/torch_parallel_ranks.BASE: the res18 C4 config at 64x96,
a global batch of 2, one frame a data rank):
  fpn   frozen res18 FPN, tp+sp (the FPN on the gathered c2..c5);
  vgg   VGG16 (POOLING_SIZE 3), det-stage uncertainty, tp: fc6 and fc7
        column parallel, their dropout live (the rank's channels of the
        whole mask), the predictors' stacks row parallel;
  bev   res18 live BN on 200 x 175 x 15 rasters, tp+sp: 200 rows split,
        13 rows at stride 16 (6 and 7 a rank);
  live  res18 live BN, tp+sp (the backbone's statistics over every rank,
        the tail's over the data group);
  uc    res50 live BN with every UC.* flag, tp+sp: the Bottleneck tail's
        drop1, drop2d, drop3 on the rank's channels, the backbone's on its
        rows;
  (vgg and uc also serve through the sharded tail, T = 2 MC samples;)
  mobile MobileNetV1 (its BN affines training), tp+sp: the head's
        depthwise convs on row slabs, the tail's depthwise convs on the
        rank's channels with no gather, its pointwise convs column
        parallel;
  m1    MESH.SPATIAL with MESH.MODEL 1: a no-op, 4 data ranks of one frame.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.config import (  # noqa: E402
    cfg_from_list,
    default_config,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (  # noqa: E402
    FasterRCNN,
    TrainDraws,
    UCDraws,
    init_detector,
    live_bn_stats,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import spatial  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (  # noqa: E402
    Solver,
    batch_to_device,
    detect,
    draw_train_keys,
    make_train_step,
    step_generator,
)
from tests import torch_parallel_ranks as R  # noqa: E402

K = 2
WORLD = 4  # data 2 x model 2
TP = ("MESH.MODEL", "2")
TP_SP = TP + ("MESH.SPATIAL", "True")
CASES = {
    "fpn": R.BASE + ("USE_FPN", "True", "POOLING_MODE", "multiscale") + TP_SP,
    "vgg": R.BASE + ("NET_VARIANT", "vgg16", "POOLING_SIZE", "3") + chip_smoke.UC_OVERRIDES + TP
    + ("UC.E_NUM_SAMPLE", "2"),
    "bev": R.CASES["bev"] + TP_SP,
    "live": R.CASES["live"] + TP_SP,
    "uc": R.BASE + R.LIVE + ("NET_VARIANT", "res50") + chip_smoke.UC_ALL_OVERRIDES + TP_SP
    + ("UC.E_NUM_SAMPLE", "2"),
    "mobile": R.BASE + ("NET_VARIANT", "mobile", "RESNET.FIXED_BLOCKS", "-1") + TP_SP,
    "m1": R.BASE + R.LIVE + ("MESH.DATA", "4", "MESH.MODEL", "1", "MESH.SPATIAL", "True"),
}
# the JAX model-parallel test's overrides (tests/test_model_parallel.py:28-46),
# a (2, 2) mesh over a global batch of 4 (two frames a data rank)
JAX_BASE = (
    "NET_TYPE", "image", "NET_VARIANT", "res18", "COMPUTE_DTYPE", "float32",
    "MESH.DATA", "2", "MESH.MODEL", "2",
    "TRAIN.RPN_POST_NMS_TOP_N", "32", "TRAIN.ROI_BATCH_SIZE", "16", "STATIC.NMS_PRE_TRAIN", "128",
    "STATIC.MAX_GT", "8", "ANCHOR_SCALES", "[4,8]", "ANCHOR_RATIOS", "[0.5,1,2]",
    "PIXEL_STDDEVS", "[60.,60.,60.]",
)
JAX_B = 4


def jax_overrides(spatial_on: bool) -> tuple:
    return JAX_BASE + ("MESH.SPATIAL", str(spatial_on))


def config(case: str):
    return cfg_from_list(default_config(), CASES[case])


def batch_size(cfg) -> int:
    return cfg.mesh.data


def global_batch(cfg) -> Dict:
    """The first batch of the case's loader, every row (on the CPU)."""
    return BatchLoader(_dataset(cfg), cfg, batch_size(cfg), device="cpu", seed=0).next()


def _dataset(cfg, mode: str = "train", seed: int = 0):
    n = 2 * batch_size(cfg)
    if cfg.net_type == "lidar":
        return SyntheticDataset(cfg, num_frames=n, num_classes=K, mode=mode, seed=seed)
    return SyntheticDataset(cfg, num_frames=n, num_classes=K, image_hw=R.HW, mode=mode, seed=seed)


_INIT: Dict[tuple, torch.nn.Module] = {}


def model_for(cfg, case: str, dp: Optional[mesh.DataParallel] = None):
    """The case's initial model (seed 0), whole; a rank other than 0 builds
    it uninitialized (broadcast_parameters_ fills it with rank 0's)."""
    empty = dp is not None and dp.rank != 0
    key = (case, empty)
    if key not in _INIT:
        if empty:
            with torch.device("meta"):
                model = FasterRCNN(cfg, K)
            model = model.to_empty(device="cpu")
        else:
            model = init_detector(cfg, K, seed=0)
            if cfg.uc.en_rpn_cls_aleatoric or cfg.uc.en_rpn_bbox_aleatoric:
                chip_smoke.scale_rpn_heads(model)
        _INIT[key] = model.to(memory_format=torch.channels_last).train()
    return copy.deepcopy(_INIT[key])


SERVE_CASES = ("vgg", "uc")  # serving through the sharded tail: the MC samples


def serve(model, batch: Dict, dp: Optional[mesh.DataParallel] = None) -> Dict:
    """solver.detect (forward_test in eval mode, the val detections' pass)
    on the batch's frames, the uncertainty's draws from a generator seeded
    0: every output on the host."""
    draws = UCDraws(torch.Generator().manual_seed(0))
    out = detect(model, batch["data"], batch["window"], draws, dp)
    flat = {k: v for k, v in out.items() if not isinstance(v, dict)}
    for key in ("uncertainties", "rpn_uncertainties"):
        flat.update({f"{key}/{k}": v for k, v in out.get(key, {}).items()})
    return {k: v.detach().clone() for k, v in flat.items()}


def step(cfg, case: str, batch: Dict, dp: Optional[mesh.DataParallel] = None) -> Dict:
    """One training step of the case's model on a device batch (a rank's
    rows with `dp`): the reported losses, the trainable parameters after
    the update (gathered whole), the live-BN running statistics, the
    sampled labels, and the tail's bytes on this rank against whole.  For
    SERVE_CASES first a serving pass of the initial model (`serve`) on
    these frames."""
    model = model_for(cfg, case, dp)
    whole = tp.tail_bytes(model)
    mesh.broadcast_parameters_(model, dp)
    held = tp.tail_bytes(model)
    served = serve(model, batch, dp) if case in SERVE_CASES and dp is not None else None
    run = make_train_step(model, DetectorSGD(model, cfg, dp=dp), dp)
    losses, aux = run(batch, draw_train_keys(model, batch, step_generator(0, 0, "cpu"), dp))
    split = model.rows_split
    if tp.is_sharded(model):
        tp.unshard_model_(model, dp)
    return {
        "losses": {k: float(v) for k, v in losses.items()},
        "params": {k: p.detach().clone() for k, p in model.named_parameters()
                   if p.requires_grad},
        "stats": {k: v.detach().clone() for k, v in live_bn_stats(model).items()},
        "anchor_labels": aux.anchor_targets.labels.clone(),
        "roi_labels": aux.proposal_targets.labels.clone(),
        "tail_bytes": (held, whole), "rows_split": split, "served": served,
    }


def reference_serving(case: str) -> list:
    """The one-process serving pass (`serve`) on each data rank's rows of
    the global batch, by data index."""
    cfg = config(case)
    full = global_batch(cfg)
    model = model_for(cfg, case)
    out = []
    for d in range(cfg.mesh.data):
        rows = mesh.local_batch_rows(d, cfg.mesh.data, batch_size(cfg))
        part = {k: (v[rows] if getattr(v, "ndim", 0) else v) for k, v in full.items()}
        out.append(serve(model, batch_to_device(part, torch.device("cpu"))))
    return out


def reference(case: str) -> Dict:
    """The one-process step on the global batch."""
    cfg = config(case)
    return step(cfg, case, batch_to_device(global_batch(cfg), torch.device("cpu")))


def _view(dp: mesh.DataParallel, cfg) -> mesh.DataParallel:
    """The 2 x 2 ranks as the case's mesh: tp without the row split, or
    with MESH.MODEL 1 four data ranks on the default group."""
    if cfg.mesh.model == 1:
        return mesh.DataParallel(dp.rank, dp.world, dp.device, dp.backend)
    return dataclasses.replace(dp, spatial=bool(cfg.mesh.spatial))


def step_cases(rank: int, world: int, init_method: str, out: str, cases=tuple(CASES)) -> int:
    """A rank's step of each case, saved to out/<case>_<rank>.pt (the
    parameters and statistics from rank 0 alone); then, if asked, "jax":
    the pinned steps against JAX's mesh step on the inputs the test's
    process writes to out/jax_<tp|tp+sp>.pt meanwhile (pinned_step);
    "solver": the resume runs (solver_runs)."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # the JSONL logs only
    base = mesh.init_data_parallel(config("live"), 2, rank=rank, world=world,
                                   init_method=init_method, device="cpu")
    try:
        for case in (c for c in cases if c in CASES):
            cfg = config(case)
            dp = _view(base, cfg)
            local = batch_to_device(BatchLoader(_dataset(cfg), cfg, batch_size(cfg), device="cpu",
                                                seed=0, dp=dp).next(), dp.device)
            res = step(cfg, case, local, dp)
            if rank != 0:
                res = {k: res[k] for k in ("losses", "anchor_labels", "roi_labels", "tail_bytes",
                                           "rows_split", "served")}
            torch.save(res, os.path.join(out, f"{case}_{rank}.pt"))
        if "jax" in cases:
            for name in ("tp", "tp+sp"):
                path = os.path.join(out, f"jax_{name}.pt")
                R.wait_for(path)
                pinned_step(base, path)
        if "solver" in cases:
            solver_runs(base, out)
    finally:
        mesh.shutdown(base)
    return rank


def pinned_step(base: mesh.DataParallel, path: str) -> None:
    """A rank's step against JAX's (2, 2) mesh step on given inputs
    (torch.load(path): the overrides, JAX's initial variables in the
    port's layout, the global batch of 4, JAX's draws and proposal lanes;
    or {"error": ...} when the test's process could not make them): its
    rows of the batch, the draws and the lanes; the model sharded as the
    mesh shards it.  Saves the reported losses, what each rank holds of
    the tail, the shard dims and (rank 0) the updated parameters, whole,
    to <path>.<rank>."""
    inp = torch.load(path, weights_only=False)
    if "error" in inp:
        return
    cfg = cfg_from_list(default_config(), inp["overrides"])
    dp = _view(base, cfg)
    model = FasterRCNN(cfg, K).to(memory_format=torch.channels_last).train()
    model.load_state_dict(inp["state"])
    whole = tp.tail_bytes(model)
    mesh.broadcast_parameters_(model, dp)
    out = {"tail_bytes": (tp.tail_bytes(model), whole), "dims": dict(model.shard_dims)}
    rows = dp.rows(JAX_B)
    local = mesh.shard_batch(inp["batch"], dp)
    draws = TrainDraws(*(None if d is None else d[rows] for d in inp["draws"]))
    lanes = tuple(t[rows] for t in inp["lanes"])
    run = make_train_step(model, DetectorSGD(model, cfg, dp=dp), dp)
    losses, _ = run(local, draws, lanes)
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["rows_split"] = model.rows_split
    tp.unshard_model_(model, dp)
    if dp.rank == 0:
        out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.save(out, f"{path}.{dp.rank}")


# -- the Solver's snapshots across mesh shapes ----------------------------------------

SOLVER = R.SOLVER + TP_SP + ("TRAIN.SNAPSHOT_ITERS", "1")
SOLVER_STEPS = 2


def make_solver(out_dir: str, dp: Optional[mesh.DataParallel]) -> Solver:
    """The SOLVER config's Solver (res18 live BN, the val cycle at step 2):
    a rank's rows with `dp`, the live case's initial weights."""
    cfg = cfg_from_list(default_config(), SOLVER)
    train = BatchLoader(R.dataset(cfg), cfg, R.B, device="cpu", seed=0, dp=dp)
    val = BatchLoader(R.dataset(cfg, mode="val", seed=101), cfg, R.B, device="cpu", seed=1, dp=dp)
    model = model_for(config("live"), "live", dp)
    return Solver(cfg, model, train, val_loader=val, output_dir=out_dir, dp=dp)


def resume(snapshot: str, out_dir: str, dp: Optional[mesh.DataParallel]) -> list:
    """A new Solver in a fresh `out_dir` resuming from a copy of
    `snapshot`: the losses of the steps it runs to SOLVER_STEPS."""
    import shutil

    if dp is None or dp.is_main:
        os.makedirs(os.path.join(out_dir, "checkpoints"), exist_ok=True)
        shutil.copy(snapshot, os.path.join(out_dir, "checkpoints", os.path.basename(snapshot)))
    mesh.barrier(dp)
    return make_solver(out_dir, dp).train(SOLVER_STEPS)["history"]


def solver_runs(dp: mesh.DataParallel, out: str) -> None:
    """2 x 2 Solver runs: 'mesh' uninterrupted for SOLVER_STEPS steps (a
    snapshot each step); 'from_one' resuming from the one-process run's
    iter_1 (out/one/checkpoints/iter_1, written by the test's process
    meanwhile).  Saves the histories and the val scalars to
    out/solver_<rank>.pt."""
    a = make_solver(os.path.join(out, "mesh"), dp).train(SOLVER_STEPS)
    one = os.path.join(out, "one", "checkpoints", "iter_1")
    R.wait_for(one)
    b = resume(one, os.path.join(out, "from_one"), dp)
    torch.save({"mesh": a["history"], "from_one": b, "tail_bytes": a["tail_bytes"]},
               os.path.join(out, f"solver_{dp.rank}.pt"))


# -- the halo exchange's adjoint ----------------------------------------------------------

HALO_WORLD = 3


def halo_ops():
    """(name, whole-map function, kernel, stride, padding, pad value) of
    the row exchange's checks: a 3x3 stride-1 conv, a 3x3 stride-2 conv, a
    1x1 stride-2 conv (rows 2o) and the stem's 3x3 stride-2 max-pool (-inf
    beyond the map)."""
    g = torch.Generator().manual_seed(0)
    w3 = torch.randn(2, 2, 3, 3, generator=g, dtype=torch.float64)
    w1 = torch.randn(2, 2, 1, 1, generator=g, dtype=torch.float64)
    conv = torch.nn.functional.conv2d
    return [
        ("conv3 s1", lambda x: conv(x, w3, padding=1), w3, 1, 1),
        ("conv3 s2", lambda x: conv(x, w3, stride=2, padding=1), w3, 2, 1),
        ("conv1 s2", lambda x: conv(x, w1, stride=2), w1, 2, 0),
        ("maxpool3 s2", lambda x: torch.nn.functional.max_pool2d(x, 3, 2, 1), None, 2, 1),
    ]


def _slab_op(x, weight, stride, padding):
    """The rank's output rows of the op through spatial's layers."""
    if weight is None:
        return spatial.max_pool2d(x, 3, stride, padding)
    m = spatial.Conv2d(weight.shape[1], weight.shape[0], weight.shape[-1], stride=stride,
                       padding=padding, bias=False).double()
    with torch.no_grad():
        m.weight.copy_(weight)
    m.weight.requires_grad_(False)
    return m(x)


def halo_checks(rank: int, world: int, init_method: str, h: int, out: str) -> int:
    """Each op of halo_ops on this rank's rows of an (1, 2, h, 3) float64
    map split over `world` ranks (uneven slabs): the output rows against
    the whole map's, and a gradcheck of the global function (every rank
    perturbs the same global input element in turn, so the ranks' collective
    calls stay in step): the Jacobian from the rows' backward against
    central differences.  Saves the largest errors to out/halo_<rank>.pt."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init_method, rank=rank,
                                         world_size=world)
    dp = mesh.DataParallel(rank, world, torch.device("cpu"), "gloo", model=world, spatial=True,
                           data_group=None, model_group=None)
    dp = dataclasses.replace(dp, model_group=torch.distributed.new_group(list(range(world))))
    errs = {}
    try:
        g = torch.Generator().manual_seed(1)
        full = torch.randn(1, 2, h, 3, generator=g, dtype=torch.float64)
        for name, whole_fn, weight, s, p in halo_ops():
            want = whole_fn(full)

            def rows_of(x_full):
                lo, hi = spatial.floor_rows(h, world, rank)
                with mesh.data_parallel(dp), spatial.row_split(dp, h, x_full.shape[3]):
                    return _slab_op(x_full[:, :, lo:hi], weight, s, p)

            got = rows_of(full)
            o0, o1 = spatial.floor_rows(want.shape[2], world, rank)
            fwd = float((got - want[:, :, o0:o1]).abs().max()) if o1 > o0 else 0.0
            # Jacobian columns by central differences of the global input
            eps = 1e-6
            n_in = full.numel()
            numeric = []
            for i in range(n_in):
                d = torch.zeros(n_in, dtype=torch.float64)
                d[i] = eps
                d = d.reshape(full.shape)
                numeric.append(((rows_of(full + d) - rows_of(full - d)) / (2 * eps)).reshape(-1))
            numeric = torch.stack(numeric, 1)  # (this rank's outputs, global inputs)
            # Jacobian rows from the backward: for each rank q and each of its
            # outputs k, every rank runs backward (q seeds e_k, the others 0:
            # their exchange runs too) and the ranks' input gradients, placed
            # in their rows and summed, are the row of q's output k
            analytic = []
            lo, hi = spatial.floor_rows(h, world, rank)
            for q in range(world):
                for k in range(max_out(h, world, whole_fn, full)):
                    x = full[:, :, lo:hi].clone().requires_grad_(True)
                    with mesh.data_parallel(dp), spatial.row_split(dp, h, full.shape[3]):
                        y = _slab_op(x, weight, s, p)
                    gy = torch.zeros(y.numel(), dtype=torch.float64)
                    if q == rank and k < y.numel():
                        gy[k] = 1.0
                    (gx,) = torch.autograd.grad(y, x, gy.reshape(y.shape))
                    row = torch.zeros_like(full)
                    row[:, :, lo:hi] = gx
                    torch.distributed.all_reduce(row, group=dp.model_group)
                    if q == rank and k < y.numel():
                        analytic.append(row.reshape(-1))
            analytic = (torch.stack(analytic) if analytic
                        else torch.zeros(0, n_in, dtype=torch.float64))
            errs[name] = (fwd, float((analytic - numeric).abs().max()) if analytic.numel() else 0.0,
                          tuple(got.shape))
    finally:
        torch.distributed.destroy_process_group()
    torch.save(errs, os.path.join(out, f"halo_{rank}.pt"))
    return rank


def max_out(h, world, whole_fn, full) -> int:
    """The largest number of output elements any rank holds: the backward
    loop's length, the same on every rank."""
    out_h = whole_fn(full).shape[2]
    per = max(b - a for a, b in (spatial.floor_rows(out_h, world, j) for j in range(world)))
    return per * full.shape[1] * whole_fn(full).shape[3]
