"""The training step, the training loop and the Solver around it.

Port of faster_rcnn_pytorch_multimodal_tpu/training/solver.py.  The parameters stay float32
masters.  With COMPUTE_DTYPE bfloat16 the forward runs on bfloat16 casts of
every float32 parameter and buffer, as the JAX package's `cast_for_compute`
does, through torch.func.functional_call; the casts are differentiable, so
the gradients land on the float32 masters.  torch.autocast is not used: it
would run the frozen-BN affine in float32 on bfloat16 activations, which
changes both the dtype flow and the memory.

With live BN (RESNET.FIXED_BLOCKS -1) the running statistics are not cast:
the call gets the model's own float32 buffers, so the statistics' in-place
update lands on the model, as the JAX package writes the mutated
`batch_stats` collection back into its state (solver.py:86-88).  Steps run
in train mode (batch statistics); `detect` runs a serving pass in eval mode
(running statistics) and puts the model back in the mode it found.

The random draws of a step (TrainDraws) come from an explicit
torch.Generator on the model's device; with uncertainty that generator also
gives the step's dropout masks and the Bayesian cross-entropies' normals
(TrainDraws.uc), and `detect` draws the serving pass's from one the caller
gives.

`Solver` (JAX :199-579) drives `train` with what a real run needs:
snapshots of the model, the optimizer and the loader's sampler every
TRAIN.SNAPSHOT_ITERS steps and at the end (keep-last-TRAIN.SNAPSHOT_KEPT,
written to a temporary name and renamed), resume from the newest one,
exact because each step's draws depend only on (seed, step)
(`step_generator`, as JAX folds the step into its key); a stop on SIGINT or
SIGTERM that snapshots after the step in flight; the val cycle every
TRAIN.DISPLAY steps (`make_eval_step`'s losses, `act_summary`'s activation
statistics, val detections drawn or RPN recall logged); staged pretrained
preload (modes 1 and 2); and the MetricsWriter logs.

Data parallelism (`dp`, a parallel.DataParallel: one rank a device, JAX's
mesh over every device, solver.py:234-242, :499-511, :557): every rank runs
this code on its rows of the global batch (the loaders' `rows`).  The step
runs its forward inside parallel.data_parallel, so live BN's statistics,
the losses' denominators and the draws (`draw_train_keys`' row blocks of
the global batch's) are the global batch's; each rank's loss is its share
of the global loss, the optimizer sums the ranks' gradients before its
clip (DetectorSGD), and the reported losses are the summed shares.  The
Solver snapshots and logs on rank 0 alone (a barrier follows each
snapshot), every rank resumes from the snapshot rank 0 finds, one rank's
SIGINT or SIGTERM stops every rank after the same step (the stop flag is
all-reduced each step), and the val cycle's losses and activation
statistics are global; val detections are drawn on rank 0, from its rows,
and the RPN recall is summed over the ranks.  With one rank (dp None)
nothing of this runs.

On a model axis (MESH.MODEL > 1) the ranks of a model group hold the same
rows: the draws are their data index's row block, the losses, statistics
and activation summaries reduce over the data group, and each rank holds
its shard of the tail (parallel.tensor_parallel).  `Solver.train` keeps the
model whole until every rank holds rank 0's weights
(mesh.broadcast_parameters_, which then shards them with the momentum
buffers), so a restore or a preload always reads a whole state dict;
snapshots gather the whole model and optimizer first (every rank takes
part, rank 0 writes), so a snapshot written at 2 x 2 resumes in one
process and the reverse; train() hands the model back whole.  The val
detections run on the model group of data rank 0 (every rank of it takes
part in the tail's collectives; rank 0 draws).
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import signal
import time
from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import host_to_device
from faster_rcnn_pytorch_multimodal_tpu_torch.inference import eval_mode, filter_batch, model_device
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (
    FasterRCNN,
    TrainDraws,
    UCDraws,
    check_supported,
    init_detector,
    live_bn_stats,
    stem_key,
    uses_uncertainty,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import LiveBatchNorm
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import tensor_parallel as tp
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.mesh import DataParallel
from faster_rcnn_pytorch_multimodal_tpu_torch.training.metrics import MetricsWriter, NullWriter
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (
    replicate_conv1_for_lidar,
    torch_key_to_flax_path,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer, span


def create_train_state(
    cfg: Config, num_classes: int, device: torch.device | str, seed: int = 0
) -> tuple[FasterRCNN, DetectorSGD]:
    """A randomly initialized float32 detector on `device` (channels_last)
    and its optimizer, which freezes the stem, the fixed blocks and the BN."""
    check_supported(cfg, training=True)
    model = init_detector(cfg, num_classes, seed)
    model = model.to(device=device, memory_format=torch.channels_last).train()
    return model, DetectorSGD(model, cfg)


def cast_for_compute(model: FasterRCNN) -> Dict[str, torch.Tensor]:
    """Compute copies of the model's parameters and buffers: float32
    tensors cast to the compute dtype (differentiable casts), except the
    live-BN running statistics, which are the model's own float32 buffers;
    others as they are."""
    dtype = model.compute_dtype
    stats = live_bn_stats(model)
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {k: v.to(dtype) if v.dtype == torch.float32 and k not in stats else v
            for k, v in named}


def compute_call(model: FasterRCNN, method, *args, **kwargs):
    """model.<method>(*args, **kwargs) (or method(model, *args, **kwargs)
    for a function) in cfg.compute_dtype: on the float32 model as it is,
    else through functional_call on cast_for_compute."""
    if model.compute_dtype == torch.float32:
        fn = getattr(model, method) if isinstance(method, str) else partial(method, model)
        return fn(*args, **kwargs)
    with span("train.cast"):
        params = cast_for_compute(model)
    with span("train.functional_call"):  # its own time: binding the copies and back
        return torch.func.functional_call(model, params, args, dict(kwargs, method=method))


def detect(
    model: FasterRCNN, images: torch.Tensor, window: torch.Tensor,
    draws: Optional[UCDraws] = None, dp: Optional[DataParallel] = None,
) -> Dict[str, torch.Tensor]:
    """One serving pass of a model in training (forward_test in the compute
    dtype, in eval mode, without gradients), as the JAX package's quality
    runs call forward_test on cast_for_compute(params); `draws` gives the
    uncertainty's masks and normals (see FasterRCNN.forward_test).  With a
    model axis (`dp`) every rank of the model group calls it on the same
    frames."""
    with eval_mode(model), torch.no_grad(), mesh.data_parallel(dp):
        return compute_call(model, "forward_test", images, window, draws=draws)


def batch_to_device(batch: Mapping[str, object], device: torch.device) -> Dict[str, object]:
    """A loader batch on `device`: arrays become tensors (through pinned
    memory on a card), tensors (a lidar batch's raster, made on the loader's
    device) move if they are elsewhere, scale_idx an int; keys starting
    with '_' (loader bookkeeping) are dropped."""
    out: Dict[str, object] = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        if k == "scale_idx":
            out[k] = int(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device, non_blocking=True)
        else:
            out[k] = host_to_device(v, device)
    return out


def draw_train_keys(
    model: FasterRCNN, batch: Mapping[str, object], generator: torch.Generator,
    dp: Optional[DataParallel] = None,
) -> TrainDraws:
    """The step's random draws for a device batch, from `generator` (which
    lives on the batch's device); with uncertainty a UCDraws on the same
    generator for the step's dropout masks and normals.  With `dp` the
    batch is a rank's rows: the global batch's keys are drawn (the same
    generator on every rank) and the rank's row block is kept, as JAX's
    one key draws for the global batch."""
    data, gt = batch["data"], batch["gt_boxes"]
    b, g = gt.shape[:2]
    rank, world = (dp.data_rank, dp.data_world) if dp is not None else (0, 1)
    n, r = model.train_lane_counts(tuple(data.shape[1:3]), g)
    kw = dict(generator=generator, device=data.device)

    def draw(fn, *size):
        return fn((b * world,) + size, **kw)[rank * b:(rank + 1) * b]

    noise = draw(torch.randn, g, 4) if model.cfg.train.use_gt_noise else None
    uc = UCDraws(generator, shard=(rank, world)) if uses_uncertainty(model.cfg) else None
    return TrainDraws(
        draw(torch.rand, n), draw(torch.rand, n), draw(torch.rand, r), draw(torch.rand, r),
        noise, uc,
    )


def make_train_step(
    model: FasterRCNN, optimizer: DetectorSGD, dp: Optional[DataParallel] = None
) -> Callable:
    """step(batch, draws, proposals=None) -> (detached losses, TrainAux):
    one forward, backward and optimizer update.  `batch` is a device batch
    (batch_to_device); `proposals` pins the second stage to given lanes.
    With `dp` the batch is a rank's rows: the forward's statistics and
    means are the global batch's (a rank's losses are its shares), the
    optimizer (given the same dp) sums the gradients, and the losses
    returned are the global ones (the shares summed)."""
    if dp is not None and optimizer.dp is not dp:
        raise ValueError("make_train_step: a data-parallel step needs DetectorSGD(..., dp=dp), "
                         "which sums the ranks' gradients")

    def step(batch, draws: TrainDraws, proposals=None):
        optimizer.zero_grad()
        args = (batch["data"], batch["gt_boxes"], batch["gt_mask"], batch["window"], draws)
        kwargs = dict(
            gt_boxes_dc=batch.get("gt_boxes_dc"), dc_mask=batch.get("dc_mask"),
            scale_idx=batch.get("scale_idx"), proposals=proposals,
        )
        with mesh.data_parallel(dp), span("train.forward"):
            losses, aux = compute_call(model, "forward_train", *args, **kwargs)
        with span("train.backward"):
            losses["total_loss"].backward()
        with span("train.optimizer"):
            optimizer.step()
        return mesh.reduce_losses({k: v.detach() for k, v in losses.items()}, dp), aux

    return step


def step_generator(seed: int, step: int, device: torch.device | str) -> torch.Generator:
    """The generator of step `step`'s draws, seeded from (seed, step) alone
    through numpy's SeedSequence, as the JAX package folds the step into
    its key (fold_in(rng, state.step)): a resumed run draws what an
    uninterrupted one does."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(s)


def train(
    model: FasterRCNN,
    optimizer: DetectorSGD,
    loader,
    iters: int,
    generator: Union[torch.Generator, Callable[[int], torch.Generator]],
    on_step: Optional[Callable[[int, Dict[str, float], float], Optional[bool]]] = None,
    first_step: int = 0,
    dp: Optional[DataParallel] = None,
    first_batch: Optional[Callable[[Dict[str, object]], None]] = None,
) -> Dict[str, List]:
    """Run `iters` steps, numbered from first_step: loader batch -> H2D ->
    draws -> step.  `generator` gives the draws: one generator for every
    step, or a callable step -> generator (`step_generator`).  Each step is
    timed from the H2D copy to the end of the update (CUDA events on a
    card, the host clock on the CPU).  Returns per-step float losses and
    milliseconds, and with `dp` (a rank of a data-parallel run: the loader
    gives its rows, the optimizer sums over its ranks) each step's
    gradient all-reduce ms (`reduce_ms`); on_step(i, losses, ms) is called
    after step i, and when it returns True the loop ends there;
    first_batch(batch) is called with the first step's device batch before
    that step (inside its timing).  The model is put in train mode.  Under a
    running torch profiler each step is a `train.step` span
    (utils.timer.span), closed before on_step."""
    device = model_device(model)
    model.train()
    step = make_train_step(model, optimizer, dp)
    timer = DeviceTimer(device)
    all_losses, all_ms, reduce_ms = [], [], []
    for i in range(first_step, first_step + iters):
        with span("train.step"):
            with span("train.data"):
                host = loader.next()
            timer.start()
            with span("train.h2d"):
                batch = batch_to_device(host, device)
            mesh.check_same_shape(batch["data"].shape, dp, "the batch's data shape")
            if first_batch is not None and i == first_step:
                first_batch(batch)
            gen = generator(i) if callable(generator) else generator
            with span("train.draws"):
                draws = draw_train_keys(model, batch, gen, dp)
            losses, _ = step(batch, draws)
            ms = timer.stop()
            with span("sync.losses"):
                losses = {k: float(v) for k, v in losses.items()}
        all_losses.append(losses)
        all_ms.append(ms)
        if optimizer.last_reduce_ms is not None:
            reduce_ms.append(optimizer.last_reduce_ms)
        if on_step is not None and on_step(i, losses, ms):
            break
    return {"losses": all_losses, "ms": all_ms, "reduce_ms": reduce_ms}


# -- the val cycle (JAX solver.py:95-173) --------------------------------------


@contextlib.contextmanager
def frozen_running_stats(model: torch.nn.Module):
    """Within the block live BN in train mode normalizes with the batch's
    statistics but leaves the running statistics as they are."""
    bns = [m for m in model.modules() if isinstance(m, LiveBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield model
    finally:
        for m in bns:
            m.update_stats = True


def make_eval_step(model: FasterRCNN, dp: Optional[DataParallel] = None) -> Callable:
    """eval_step(batch, draws) -> detached losses: forward_train on a val
    batch without an update, in train mode (live BN on the batch's
    statistics), the running statistics untouched, as the JAX package's
    eval step applies forward_train with `batch_stats` not mutable.  With
    `dp` the batch is a rank's rows and the losses are the global batch's,
    as JAX's eval step on a sharded batch (solver.py:557)."""

    def eval_step(batch, draws: TrainDraws) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.train()
        try:
            with frozen_running_stats(model), torch.no_grad(), mesh.data_parallel(dp):
                losses, _ = compute_call(
                    model, "forward_train", batch["data"], batch["gt_boxes"], batch["gt_mask"],
                    batch["window"], draws, gt_boxes_dc=batch.get("gt_boxes_dc"),
                    dc_mask=batch.get("dc_mask"), scale_idx=batch.get("scale_idx"))
        finally:
            model.train(was_training)
        return mesh.reduce_losses({k: v.detach() for k, v in losses.items()}, dp)

    return eval_step


def act_summary(
    model: FasterRCNN, images: torch.Tensor, dp: Optional[DataParallel] = None
) -> Dict[str, torch.Tensor]:
    """Mean, std and absmax of the map the JAX package sows as `act_conv`
    (the C4 backbone output, or p2 under FPN), from `features` in eval mode
    (running statistics), keyed act_conv0/mean|std|absmax as JAX's
    make_act_summary_step keys its one sown leaf.  With `dp` the images are
    a rank's rows and the statistics the global batch's (the std about the
    global mean), each element counted once: over the data group, since
    `features` hands every rank of a model group the whole map."""
    with eval_mode(model), torch.no_grad(), mesh.data_parallel(dp):
        feats = compute_call(model, "features", images)
    a = (feats[0] if isinstance(feats, tuple) else feats).float()
    if dp is None:
        return {"act_conv0/mean": a.mean(), "act_conv0/std": a.std(unbiased=False),
                "act_conv0/absmax": a.abs().max()}
    n = a.numel() * dp.data_world
    mean = mesh.reduce_sum(a.sum(), dp) / n
    var = mesh.reduce_sum((a - mean).square().sum(), dp) / n
    return {"act_conv0/mean": mean, "act_conv0/std": var.sqrt(),
            "act_conv0/absmax": mesh.reduce_max(a.abs().max(), dp)}


# -- snapshots and weights -------------------------------------------------------


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """A state dict in the port's layout from `path`: an `.npz` of arrays,
    a `.pt` written by torch.save, or a Solver snapshot (its model entry)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and "optimizer" in state and "step" in state:
        return state["model"]
    return state


def _loader_state_to_tensors(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # torch.load(weights_only=True) takes tensors, not numpy arrays; the
    # MT19937 key words (uint32) travel as int64
    out = {}
    for k, v in state.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(np.array(a, np.int64 if a.dtype == np.uint32 else a.dtype))
    return out


def _loader_state_from_tensors(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in state.items()}


_SNAPSHOT = re.compile(r"iter_(\d+)")


class _GracefulKiller:
    """SIGINT and SIGTERM set kill_now; the Solver snapshots after the step
    in flight and stops.  Off the main thread signal.signal raises
    ValueError and the killer stays inert, as in the JAX package."""

    def __init__(self):
        self.kill_now = False
        self._previous = {}
        try:
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._previous[sig] = signal.signal(sig, self._handler)
        except ValueError:
            pass

    def _handler(self, *_args):
        self.kill_now = True

    def restore(self) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
        self._previous = {}


class Solver:
    """The Solver of the JAX package (solver.py:215-579): train(max_iters) resumes
    from the newest snapshot in output_dir/checkpoints or preloads
    `pretrained_path` (PRELOAD_FULL: mode 2, else mode 1), then runs the
    steps with the train loader's prefetch on, the val cycle, the snapshots
    and the logs (output_dir/tb, and output_dir/tb_val with a val loader).

    `model` is the detector on its device (create_train_state); the
    optimizer is built in train().  `dp`: this process's rank of a
    data-parallel run (the loaders give its rows; see the module
    docstring), None for one process."""

    def __init__(
        self,
        cfg: Config,
        model: FasterRCNN,
        train_loader,
        val_loader=None,
        output_dir: str = "output",
        seed: Optional[int] = None,
        pretrained_path: Optional[str] = None,
        dp: Optional[DataParallel] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.optimizer: Optional[DetectorSGD] = None
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.output_dir = output_dir
        self.seed = cfg.rng_seed if seed is None else seed
        self.pretrained_path = pretrained_path
        self.dp = dp
        self.debug_draws: Dict[str, str] = {}
        self.is_main = dp is None or dp.is_main
        self.device = model_device(model)
        out = os.path.abspath(output_dir)
        self._ckpt_dir = os.path.join(out, "checkpoints")
        writer = MetricsWriter if self.is_main else NullWriter
        self.metrics = writer(os.path.join(out, "tb"))
        self.metrics_val = (writer(os.path.join(out, "tb"), "val") if val_loader is not None
                            else None)

    # -- checkpointing ------------------------------------------------------

    def _snapshots(self) -> List[str]:
        if not os.path.isdir(self._ckpt_dir):
            return []
        names = [d for d in os.listdir(self._ckpt_dir) if _SNAPSHOT.fullmatch(d)]
        return sorted(names, key=lambda d: int(_SNAPSHOT.fullmatch(d).group(1)))

    def snapshot(self, step: int) -> str:
        """Write checkpoints/iter_<step>: the model's state dict (float32
        masters, live-BN running statistics), the optimizer's state, the
        train loader's sampler state and the step.  It is written under a
        temporary name and renamed, so a stop mid-write leaves nothing that
        find_previous would pick; then keep-last-N.  Data-parallel: rank 0
        writes, every rank waits for it (the replicas are equal); a sharded
        model and its momentum are gathered whole for it on every rank
        first (a collective) and sharded again after."""
        path = os.path.join(self._ckpt_dir, f"iter_{step}")
        sharded = tp.is_sharded(self.model)
        if sharded:
            tp.unshard_model_(self.model, self.dp, self.optimizer)
        if self.is_main:
            os.makedirs(self._ckpt_dir, exist_ok=True)
            state = {
                "model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "loader": _loader_state_to_tensors(self.train_loader.state_dict()),
                "step": int(step),
            }
            tmp = os.path.join(self._ckpt_dir, f".iter_{step}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, path)
            self._gc_snapshots()
        if sharded:
            tp.shard_model_(self.model, self.dp, self.optimizer)
        mesh.barrier(self.dp)
        return path

    def _gc_snapshots(self) -> None:
        """keep-last-N (TRAIN.SNAPSHOT_KEPT)."""
        for d in self._snapshots()[: -self.cfg.train.snapshot_kept]:
            os.remove(os.path.join(self._ckpt_dir, d))

    def find_previous(self) -> Optional[str]:
        snaps = self._snapshots()
        return os.path.join(self._ckpt_dir, snaps[-1]) if snaps else None

    def restore(self, path: str) -> int:
        """Load a snapshot into the model, the optimizer and the train
        loader; returns its step."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.train_loader.load_state_dict(_loader_state_from_tensors(state["loader"]))
        return int(state["step"])

    def load_pretrained(self, path: str, mode: int = 1) -> List[str]:
        """Staged preload: mode 1 keeps the `backbone` and `tail` scopes of
        the weights at `path` (read_weights), mode 2 every scope but
        `predictors`; a key's scope is the root of its JAX path
        (utils.convert.torch_key_to_flax_path).  Frozen and live BN share
        their keys, so either loads into the other.  Image weights preload
        a LiDAR net: an RGB stem conv (3 input channels where the BEV stem
        takes LIDAR.NUM_CHANNEL) is spread over the height slices and meta
        channels by replicate_conv1_for_lidar.  A kept key that is missing
        or of another shape raises, with the keys named.  Returns the keys
        replaced."""
        loaded = read_weights(path)
        own = self.model.state_dict()
        stem = stem_key(self.model)
        lidar = self.cfg.lidar
        if (self.cfg.net_type == "lidar" and stem in loaded and loaded[stem].shape[1] == 3
                and own[stem].shape[1] == lidar.num_channel):
            loaded = replicate_conv1_for_lidar(loaded, lidar.num_slices, lidar.num_channel, stem)
            loaded[stem] = torch.from_numpy(loaded[stem])
        scope = {k: torch_key_to_flax_path(k)[0] for k in own}
        roots = list(dict.fromkeys(scope.values()))
        keep = ("backbone", "tail") if mode == 1 else tuple(r for r in roots if r != "predictors")
        keys = [k for k in own if scope[k] in keep]
        missing = [k for k in keys if k not in loaded]
        wrong = [f"{k} {tuple(loaded[k].shape)} != {tuple(own[k].shape)}"
                 for k in keys if k in loaded and loaded[k].shape != own[k].shape]
        if missing or wrong:
            raise ValueError(f"load_pretrained {path}: {len(missing)} keys missing "
                             f"{missing[:8]}, {len(wrong)} of another shape {wrong[:8]}")
        self.model.load_state_dict({k: loaded[k] for k in keys}, strict=False)
        print(f"preloaded mode={mode} scopes={keep} from {path}")
        return keys

    def _debug_draws(self, batch) -> Dict[str, str]:
        """The DEBUG.DRAW_* switches on the first batch of train, with the
        weights of its step (JAX solver.py:341-358), into
        output_dir/debug_draws; data-parallel: rank 0 draws its rows.
        Returns the PNGs written by switch."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.utils import debug_draw as dd

        cfg = self.cfg
        out_dir = os.path.join(self.output_dir, "debug_draws")
        written = {}
        if not self.is_main:
            return written
        if cfg.debug.draw_anchors:
            written["DRAW_ANCHORS"] = dd.draw_anchors(cfg, batch, out_dir)
        if cfg.debug.draw_anchor_t:
            written["DRAW_ANCHOR_T"] = dd.draw_anchor_targets(cfg, batch, out_dir)
        if cfg.debug.draw_proposal_t:
            written["DRAW_PROPOSAL_T"] = dd.draw_proposal_targets(cfg, self.model, batch, out_dir)
        for k, v in written.items():
            print(f"DEBUG.{k} -> {v}")
        self.debug_draws = written
        return written

    # -- the val cycle --------------------------------------------------------

    def _val_draws(self, batch) -> TrainDraws:
        """The val losses' draws: one generator seeded `seed` every cycle,
        as the JAX package passes its base key to the eval step."""
        return draw_train_keys(self.model, batch, torch.Generator(
            device=self.device).manual_seed(self.seed), self.dp)

    def _val_detections(self, val_batch, step: int, max_draw: int = 4) -> Dict[str, float]:
        """Full inference on the val batch: draw detections (full net) or
        log proposal recall (RPN only).  Returns scalars for the val log.
        Data-parallel: the recall is the global batch's (a model group's
        ranks count once); rank 0 draws its rows' detections, which the
        ranks of its model group compute with it."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.drawing import (
            draw_frame_detections,
            proposal_recall,
        )
        from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import to_per_class_lists

        cfg = self.cfg
        dp = self.dp
        if cfg.enable_full_net and dp is not None and dp.data_rank != 0:
            return {}
        draws = (UCDraws(torch.Generator(device=self.device).manual_seed(self.seed))
                 if uses_uncertainty(cfg) else None)
        out = detect(self.model, val_batch["data"], val_batch["window"], draws,
                     dp if dp is not None and dp.model > 1 else None)
        if cfg.enable_full_net and not self.is_main:
            return {}
        gt, gt_mask = val_batch["gt_boxes"], val_batch["gt_mask"].cpu().numpy()
        if not cfg.enable_full_net:
            if cfg.net_type == "lidar":
                from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_3d_to_bev_aabb

                gt = bbox_3d_to_bev_aabb(gt[..., :7])
            covered, total = proposal_recall(out["rois"].cpu().numpy(),
                                             out["roi_valid"].cpu().numpy(),
                                             gt.cpu().numpy(), gt_mask)
            once = dp is None or dp.model_rank == 0  # a model group's ranks hold one count
            covered, total = (int(v) for v in mesh.host_sum(
                (covered, total) if once else (0, 0), self.dp))
            recall = covered / max(total, 1)
            if self.is_main:
                print(f"val rpn recall@0.5: {recall:.4f} ({covered}/{total})")
            return {"rpn_recall": recall}

        classes = (getattr(self.val_loader.dataset, "classes", None)
                   or [f"cls_{j}" for j in range(self.model.num_classes)])
        filt = {k: v.cpu().numpy() for k, v in filter_batch(self.model, out, 0.5).items()}
        uc = {k: v.cpu().numpy() for k, v in out.get("uncertainties", {}).items()}
        data = val_batch["data"].cpu().numpy()
        gt = gt.cpu().numpy()
        draw_dir = os.path.join(self.output_dir, "val_draws", f"iter_{step}")
        for i in range(min(data.shape[0], max_draw)):
            boxes_j, uc_j = to_per_class_lists({k: v[i] for k, v in filt.items()},
                                               {k: v[i] for k, v in uc.items()},
                                               len(classes), cfg.num_bbox_elem)
            canvas = draw_frame_detections(cfg, data[i], boxes_j, classes,
                                           os.path.join(draw_dir, f"det_{i:03d}.png"),
                                           gt_boxes=gt[i][gt_mask[i]], uc_j=uc_j)
            if i == 0:
                self.metrics_val.image(step, "val/detections", canvas, save_png=False)
        return {}

    def _val_cycle(self, step: int) -> Dict[str, float]:
        cfg = self.cfg
        batch = batch_to_device(self.val_loader.next(), self.device)
        scalars = {k: float(v) for k, v in self._eval_step(batch, self._val_draws(batch)).items()}
        if cfg.train.en_act_summaries:
            scalars.update({k: float(v) for k, v in
                            act_summary(self.model, batch["data"], self.dp).items()})
        if cfg.train.draw_val_detections or not cfg.enable_full_net:
            scalars.update(self._val_detections(batch, step))
        self.metrics_val.scalars(step, scalars)
        return scalars

    # -- the main loop ----------------------------------------------------------

    def train(self, max_iters: int, log_every: Optional[int] = None) -> Dict:
        """Train to step max_iters.  Returns the last logged losses,
        frames/s over the run (wall clock, the global batch's frames), the
        step it ended at, every step's losses and device ms (from `train`),
        the gradient all-reduce's ms a step (data-parallel), the tail's
        bytes on this rank (its shards on a model axis) and the wall
        seconds.  The model is whole when it returns."""
        cfg = self.cfg
        dp = self.dp
        log_every = log_every or cfg.train.display
        killer = _GracefulKiller()
        self.optimizer = DetectorSGD(self.model, cfg, dp=dp)
        start = 0
        prev = mesh.broadcast_object(self.find_previous() if self.is_main else None, dp)
        if prev is not None:
            if self.is_main:
                print(f"restoring from {prev}")
            start = self.restore(prev)
        elif self.pretrained_path:
            self.load_pretrained(self.pretrained_path, 2 if cfg.preload_full else 1)
        elif cfg.resnet.fixed_blocks >= 0 and cfg.net_variant.startswith("res"):
            # fixed_blocks >= 0 freezes every BN on the assumption that
            # pretrained statistics and affines were loaded
            print("WARNING: training from scratch with RESNET.FIXED_BLOCKS="
                  f"{cfg.resnet.fixed_blocks} >= 0: frozen random BN affines will not train. "
                  "Set FIXED_BLOCKS=-1 or preload weights.")
        # one replica: rank 0's weights (a random init, a restore or a
        # preload are the same on every rank; this makes sure of it), then
        # each rank's shards on a model axis
        mesh.broadcast_parameters_(self.model, dp, self.optimizer)
        tail_bytes = tp.tail_bytes(self.model)
        self._eval_step = (make_eval_step(self.model, dp) if self.val_loader is not None
                           else None)

        last: Dict[str, float] = {}
        end = {"step": start}
        t_start = time.time()

        def on_step(it: int, losses: Dict[str, float], _ms: float) -> bool:
            n = it + 1
            end["step"] = n
            if n % log_every == 0 or n == max_iters:
                last.clear()
                last.update(losses)
                self.metrics.scalars(n, losses)
                dt = time.time() - t_start
                if self.is_main:
                    print(f"iter: {n} / {max_iters}, total loss: {losses['total_loss']:.6f}\n"
                          + "".join(f" >>> {k}: {v:.6f}\n" for k, v in losses.items()
                                    if k != "total_loss")
                          + f"speed: {dt / max(n - start, 1):.3f}s / iter, "
                          f"{(n - start) * self.train_loader.batch_size / dt:.2f} frames/s")
            if self._eval_step is not None and n % log_every == 0:
                self._val_cycle(n)
            snapped = n % cfg.train.snapshot_iters == 0 or n == max_iters
            if snapped:
                self.snapshot(n)
            if mesh.any_rank(killer.kill_now, dp):
                if not snapped:
                    self.snapshot(n)
                print(f"stopped by a signal after iteration {n}")
                return True
            return False

        self.train_loader.start(transfer=lambda b: batch_to_device(b, self.device))
        try:
            draws = cfg.debug.draw_anchors or cfg.debug.draw_anchor_t or cfg.debug.draw_proposal_t
            res = train(self.model, self.optimizer, self.train_loader, max(max_iters - start, 0),
                        lambda i: step_generator(self.seed, i, self.device), on_step, start, dp,
                        first_batch=self._debug_draws if draws else None)
        finally:
            self.train_loader.kill()
            killer.restore()
        wall = time.time() - t_start
        if tp.is_sharded(self.model):
            tp.unshard_model_(self.model, dp, self.optimizer)
        return {"losses": last, "frames_per_sec": len(res["ms"]) * self.train_loader.batch_size
                / max(wall, 1e-9), "step": end["step"], "history": res["losses"],
                "ms": res["ms"], "reduce_ms": res["reduce_ms"], "tail_bytes": tail_bytes,
                "wall_s": wall}
