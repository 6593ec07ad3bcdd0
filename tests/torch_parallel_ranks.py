"""The ranks' side of tests/test_torch_port_parallel.py: data-parallel
training steps of the port run by spawned CPU ranks over gloo
(parallel.multihost.spawn_ranks), and the same steps in one process on the
global batch, for the tests to hold against each other.  No JAX here: a
spawned rank imports this module.

A case is a configuration and a global batch of B = 2 frames (one a rank,
as JAX's data-parallel test puts one frame on each of its 8 devices):
  frozen   the JAX data-parallel test's res18 C4 config (its 64x96 frames);
  live     the same with live BN (RESNET.FIXED_BLOCKS -1);
  unequal  frozen, the second rank's frames with one GT box each and a
           narrower window, so its rows hold fewer valid anchors;
  uc       live BN, every UC.* flag (the RPN's 1x1 heads scaled as
           chip_smoke.scale_rpn_heads does, else their exp overflows);
  bev      res18 live BN on 200 x 175 x 15 BEV rasters, voxelized by each
           rank for its rows (K3's twin), K1 and K2 through their twins;
  fpn      frozen res18 FPN (K2-FPN's twin);
  mixed    live, on frames of two sizes (MIXED_HW: the global batch's first
           row 64x96, its second 128x160), so each rank's own frames pad to
           another bucket than the global batch's largest.
"""

from __future__ import annotations

import copy
import os
import signal
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
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
    init_detector,
    live_bn_stats,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (  # noqa: E402
    Solver,
    batch_to_device,
    draw_train_keys,
    make_train_step,
    step_generator,
)

B, K = 2, 2
HW = (64, 96)
# tests/test_data_parallel.py:23-40, the JAX data-parallel test's config, but
# for its anchors: [4, 8] are 64 and 128 px, across every 64x96 frame's
# border, so the RPN would sample none; [1, 2] are 16 and 32 px.  The GT
# boxes join the RoIs (TRAIN.USE_GT), so every frame has foreground RoIs
BASE = (
    "NET_TYPE", "image", "NET_VARIANT", "res18", "COMPUTE_DTYPE", "float32",
    "TRAIN.RPN_POST_NMS_TOP_N", "32", "TRAIN.ROI_BATCH_SIZE", "16", "STATIC.NMS_PRE_TRAIN", "128",
    "STATIC.MAX_GT", "8", "ANCHOR_SCALES", "[1,2]", "ANCHOR_RATIOS", "[0.5,1,2]",
    "PIXEL_STDDEVS", "[60.,60.,60.]", "TRAIN.USE_GT", "True", "MESH.DATA", "2",
)
LIVE = ("RESNET.FIXED_BLOCKS", "-1")
CASES = {
    "frozen": BASE,
    "live": BASE + LIVE,
    "unequal": BASE,
    "uc": BASE + LIVE + chip_smoke.UC_ALL_OVERRIDES,
    "bev": BASE + LIVE + (
        "NET_TYPE", "lidar", "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)",
        "STATIC.MAX_POINTS", "9000", "TRAIN.USE_GT_NOISE", "True"),
    "fpn": BASE + ("USE_FPN", "True", "POOLING_MODE", "multiscale"),
    "mixed": BASE + LIVE,
}
MIXED_HW = ((64, 96), (128, 160))  # chip_smoke.MixedSizes: even frames, odd frames
STEP_CASES = tuple(CASES)


def config(case: str):
    return cfg_from_list(default_config(), CASES[case])


def dataset(cfg, num_frames: int = 2 * B, mode: str = "train", seed: int = 0,
            case: str = ""):
    if case == "mixed":
        return chip_smoke.MixedSizes(cfg, num_frames, MIXED_HW, seed, mode, K)
    if cfg.net_type == "lidar":
        return SyntheticDataset(cfg, num_frames=num_frames, num_classes=K, mode=mode, seed=seed)
    return SyntheticDataset(cfg, num_frames=num_frames, num_classes=K, image_hw=HW, mode=mode,
                            seed=seed)


_INIT: Dict[tuple, torch.nn.Module] = {}


def model_for(cfg, case: str, dp: Optional[mesh.DataParallel] = None):
    """A copy of the case's initial model, the same in every process (seed
    0; built once a process: a res18 init takes ~1-2 s here).  A rank
    other than 0 builds it uninitialized: the step's broadcast_parameters_
    (or the Solver's) fills it with rank 0's weights."""
    empty = dp is not None and dp.rank != 0
    key = (CASES[case], empty)
    if key not in _INIT:
        if empty:
            with torch.device("meta"):
                model = FasterRCNN(cfg, K)
            model = model.to_empty(device="cpu")
        else:
            model = init_detector(cfg, K, seed=0)
            if case == "uc":
                chip_smoke.scale_rpn_heads(model)
        _INIT[key] = model.to(memory_format=torch.channels_last).train()
    return copy.deepcopy(_INIT[key])


def unequal(batch: Dict) -> Dict:
    """The global batch with the second rank's rows holding one GT box each
    and a window 40 px narrower and 24 px shorter."""
    batch = dict(batch)
    half = B // 2
    mask = np.array(batch["gt_mask"])
    mask[half:, 1:] = False
    window = np.array(batch["window"])
    window[half:, 1] -= 40
    window[half:, 3] -= 24
    batch["gt_mask"], batch["window"] = mask, window
    return batch


def global_batch(cfg, case: str) -> Dict:
    """The first batch of the case's loader, every row (on the CPU)."""
    b = BatchLoader(dataset(cfg, case=case), cfg, B, device="cpu", seed=0).next()
    return unequal(b) if case == "unequal" else b


def one_step(cfg, case: str, batch: Dict, dp: Optional[mesh.DataParallel] = None,
             shard: Optional[mesh.DataParallel] = None) -> Dict:
    """One training step of the case's model on a device batch (a rank's
    rows with `dp`): the reported losses, the trainable parameters after
    the update, the live-BN running statistics and the sampled labels.
    `shard` (default `dp`) says whose rows of the global draws to take."""
    model = model_for(cfg, case, dp)
    mesh.broadcast_parameters_(model, dp)
    step = make_train_step(model, DetectorSGD(model, cfg, dp=dp), dp)
    gen = step_generator(0, 0, "cpu")
    losses, aux = step(batch, draw_train_keys(model, batch, gen, dp if shard is None else shard))
    return {
        "losses": {k: float(v) for k, v in losses.items()},
        "params": {k: p.detach().clone() for k, p in model.named_parameters()
                   if p.requires_grad},
        "stats": {k: v.detach().clone() for k, v in live_bn_stats(model).items()},
        "anchor_labels": aux.anchor_targets.labels.clone(),
        "roi_labels": aux.proposal_targets.labels.clone(),
        "checksum": checksum(model),
    }


def checksum(model: torch.nn.Module) -> float:
    """The float64 sum of every parameter and buffer: a replica's
    fingerprint, equal on every rank."""
    with torch.no_grad():
        return float(sum(t.double().sum() for t in list(model.parameters())
                         + list(model.buffers())))


def reference(case: str) -> Dict:
    """The one-process step on the global batch."""
    cfg = config(case)
    return one_step(cfg, case, batch_to_device(global_batch(cfg, case), torch.device("cpu")))


def naive_local_means(case: str) -> Dict[str, float]:
    """What per-rank local denominators would report: each rank's rows
    stepped alone on their rows of the global draws (one process, local
    means), the two losses averaged."""
    cfg = config(case)
    full = global_batch(cfg, case)
    got = []
    for rank in range(2):
        rows = mesh.local_batch_rows(rank, 2, B)
        part = {k: (v[rows] if getattr(v, "ndim", 0) else v) for k, v in full.items()}
        shard = mesh.DataParallel(rank, 2, torch.device("cpu"))
        got.append(one_step(cfg, case, batch_to_device(part, torch.device("cpu")),
                            shard=shard)["losses"])
    return {k: (got[0][k] + got[1][k]) / 2 for k in got[0]}


def step_cases(rank: int, world: int, init_method: str, out: str, cases=STEP_CASES) -> int:
    """A rank's data-parallel step of each case, saved to out/<case>_<rank>.pt:
    the loader's rows (the 'unequal' case: shard_batch of the edited global
    batch).  Rank 0 keeps the parameters and statistics, rank 1 its
    labels and checksum.  Then, if asked: "jax", the pinned live-BN step
    on the inputs the test's process writes to out/JAX_INPUTS meanwhile
    (pinned_step); "solver", the Solver runs (solver_runs)."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # the JSONL logs only
    dp = mesh.init_data_parallel(config("frozen"), B, rank=rank, world=world,
                                 init_method=init_method, device="cpu")
    try:
        for case in (c for c in cases if c in CASES):
            cfg = config(case)
            loader = BatchLoader(dataset(cfg, case=case), cfg, B, device="cpu", seed=0, dp=dp)
            if case == "unequal":
                local = mesh.shard_batch(global_batch(cfg, case), dp)
            else:
                local = batch_to_device(loader.next(), dp.device)
                rows = mesh.shard_batch(global_batch(cfg, case), dp)
                for k, v in rows.items():  # the loader's rows are the global batch's
                    assert torch.equal(torch.as_tensor(v), torch.as_tensor(local[k])), (case, k)
                if case == "mixed":
                    mixed_loaders(cfg, dp, rows)
            res = one_step(cfg, case, local, dp)
            if rank != 0:
                res = {k: res[k] for k in ("losses", "anchor_labels", "roi_labels", "checksum")}
            torch.save(res, os.path.join(out, f"{case}_{rank}.pt"))
        if "jax" in cases:
            for name in (JAX_INPUTS, JAX_MIXED_INPUTS):
                path = os.path.join(out, name)
                wait_for(path)
                pinned_step(dp, path)
        if "solver" in cases:
            solver_runs(dp, out)
    finally:
        mesh.shutdown(dp)
    return rank


def mixed_loaders(cfg, dp: mesh.DataParallel, want: Dict) -> None:
    """The mixed case's first batch from the rank's prefetch thread and from
    a worker process: the global batch's rows, padded to its bucket, as the
    serial loader gives them.  Before the pad the rank's own frames are of
    another size than the other rank's."""
    own = BatchLoader(dataset(cfg, case="mixed"), cfg, B, device="cpu", seed=0,
                      rows=dp.rows(B)).next()["data"].shape
    sizes = [None] * dp.world
    torch.distributed.all_gather_object(sizes, tuple(own))
    assert len(set(sizes)) == dp.world, f"the ranks' own frames are of one size: {sizes}"
    for workers in (0, 1):
        loader = BatchLoader(dataset(cfg, case="mixed"), cfg, B, device="cpu", seed=0, dp=dp,
                             workers=workers)
        loader.start()
        try:
            got = batch_to_device(loader.next(), dp.device)
        finally:
            loader.kill()
        for k, v in want.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(got[k])), (workers, k)


# -- the Solver ----------------------------------------------------------------------

SOLVER = BASE + LIVE + ("TRAIN.SNAPSHOT_ITERS", "2", "TRAIN.DISPLAY", "2",
                        "TRAIN.DRAW_VAL_DETECTIONS", "False", "TRAIN.EN_ACT_SUMMARIES", "True",
                        "TRAIN.SNAPSHOT_KEPT", "5")
SOLVER_STEPS = 2


class _SigtermAt:
    """A loader whose `at`-th next() sends this process SIGTERM: the
    Solver's killer sees it during that step."""

    def __init__(self, loader, at: int):
        self._loader, self._at, self._calls = loader, at, 0

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def next(self):
        self._calls += 1
        if self._calls == self._at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self._loader.next()


def make_solver(out_dir: str, dp: Optional[mesh.DataParallel], sigterm_at: int = 0) -> Solver:
    """The Solver of the SOLVER config: train and val synthetic loaders (a
    rank's rows with `dp`), the weights of seed 0."""
    cfg = cfg_from_list(default_config(), SOLVER)
    train = BatchLoader(dataset(cfg), cfg, B, device="cpu", seed=0, dp=dp)
    if sigterm_at:
        train = _SigtermAt(train, sigterm_at)
    val = BatchLoader(dataset(cfg, mode="val", seed=101), cfg, B, device="cpu", seed=1, dp=dp)
    model = model_for(config("live"), "live", dp)  # SOLVER's net: the live case's
    return Solver(cfg, model, train, val_loader=val, output_dir=out_dir, dp=dp)


def val_scalars(out_dir: str):
    import json

    with open(os.path.join(out_dir, "tb_val", "scalars.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def solver_runs(dp: mesh.DataParallel, out: str) -> None:
    """2-rank Solver runs: 'a' uninterrupted for SOLVER_STEPS steps; 'b'
    where rank 1 alone gets SIGTERM during its first step, then a new
    Solver resuming in the same directory to the end.  Each rank saves the
    histories, where the stopped run ended and the snapshots it left to
    out/solver_<rank>.pt."""
    a = make_solver(os.path.join(out, "a"), dp).train(SOLVER_STEPS)
    ckpt = os.path.join(out, "b", "checkpoints")
    stopped = make_solver(os.path.join(out, "b"), dp, sigterm_at=1 if dp.rank == 1 else 0
                          ).train(SOLVER_STEPS)
    left = sorted(os.listdir(ckpt))
    mesh.barrier(dp)  # every rank has listed them before the resume writes more
    b = make_solver(os.path.join(out, "b"), dp).train(SOLVER_STEPS)
    torch.save({"a": a["history"], "b": b["history"], "stopped_at": stopped["step"],
                "stopped_history": stopped["history"], "left": left,
                "a_reduce_ms": a["reduce_ms"]}, os.path.join(out, f"solver_{dp.rank}.pt"))


# -- the live-BN step held to JAX's 2-device mesh step ------------------------------


JAX_INPUTS = "jax_inputs.pt"  # written by the test's process while the ranks step
JAX_MIXED_INPUTS = "jax_inputs_mixed.pt"  # the same for the mixed case


def wait_for(path: str, timeout: float = 300.0) -> None:
    """Until `path` exists (written whole: the writer renames it into place)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)


def pinned_step(dp: mesh.DataParallel, path: str) -> None:
    """A rank's live-BN step on given inputs (torch.load(path): the case,
    the state dict, the global batch, JAX's draws and proposal lanes, and
    JAX's input to every ReLU, chip_smoke.relu_sites, in the port's layout
    over the global batch; or {"error": ...} when the test's process could
    not make them): forward_train on its rows, pinned to its rows of the
    lanes and with each ReLU unit whose input takes another sign than
    JAX's given JAX's gate (chip_smoke.find_ties / pinned_ties, collected
    over probe forwards until no rank finds a new one: the ranks share the
    batch statistics, so a pin on one rank moves the others'), inside
    data_parallel; backward; the gradients summed over the ranks; then the
    optimizer's update.  Saves (rank 0) the losses, the summed gradients,
    the running statistics after the forward and the updated parameters,
    (both) the losses and the ties, to <path>.<rank>."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import TrainDraws

    inp = torch.load(path, weights_only=False)
    if "error" in inp:
        return
    cfg = config(inp["case"])
    model = FasterRCNN(cfg, K).to(memory_format=torch.channels_last).train()
    model.load_state_dict(inp["state"])
    opt = DetectorSGD(model, cfg)  # the gradients are summed by hand below
    rows = dp.rows(B)
    local = mesh.shard_batch(inp["batch"], dp)
    draws = TrainDraws(*(None if d is None else d[rows] for d in inp["draws"]))
    lanes = tuple(t[rows] for t in inp["lanes"])
    want = {k: torch.from_numpy(v[dp.rows(v.shape[0])]) for k, v in inp["sites"].items()}

    def forward(m):
        with mesh.data_parallel(dp):
            return m.forward_train(local["data"], local["gt_boxes"], local["gt_mask"],
                                   local["window"], draws, proposals=lanes)

    ties = []
    for _ in range(4):
        probe = copy.deepcopy(model)
        with chip_smoke.pinned_ties(probe, ties), chip_smoke.relu_inputs(probe) as got, \
                torch.no_grad():
            forward(probe)
        new = chip_smoke.find_ties(want, got, skip={t[:3] for t in ties})
        ties += new
        if not mesh.any_rank(bool(new), dp):
            break
    with chip_smoke.pinned_ties(model, ties):
        losses, _ = forward(model)
    losses["total_loss"].backward()
    trained = {k: p for k, p in model.named_parameters() if p.requires_grad}
    for p in trained.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.all_reduce_grads_([p.grad for p in trained.values()], dp)
    reported = mesh.reduce_losses({k: v.detach() for k, v in losses.items()}, dp)
    out = {"losses": {k: float(v) for k, v in reported.items()}, "ties": ties,
           "shape": tuple(local["data"].shape)}
    if dp.rank == 0:
        out["grads"] = {k: p.grad.clone() for k, p in trained.items()}
        out["stats"] = {k: v.clone() for k, v in live_bn_stats(model).items()}
        opt.step()
        out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.save(out, f"{path}.{dp.rank}")


def failing_rank(rank: int, world: int, init_method: str) -> int:
    """Rank 1 raises after the group starts while rank 0 waits for it in an
    all-reduce: the launcher must stop rank 0 and raise rank 1's error."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return rank
