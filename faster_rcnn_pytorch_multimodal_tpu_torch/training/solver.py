"""The training step and a minimal train loop.

Port of faster_rcnn_pytorch_multimodal_tpu/training/solver.py
`make_train_step` and `create_train_state`.  The parameters stay float32
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
gives.  Snapshots, resume and the val cycle
are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.inference import eval_mode, model_device
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (
    FasterRCNN,
    TrainDraws,
    UCDraws,
    check_supported,
    init_detector,
    live_bn_stats,
    uses_uncertainty,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer


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


def compute_call(model: FasterRCNN, method: str, *args, **kwargs):
    """model.<method>(*args, **kwargs) in cfg.compute_dtype: on the float32
    model as it is, else through functional_call on cast_for_compute."""
    if model.compute_dtype == torch.float32:
        return getattr(model, method)(*args, **kwargs)
    return torch.func.functional_call(
        model, cast_for_compute(model), args, dict(kwargs, method=method))


def detect(
    model: FasterRCNN, images: torch.Tensor, window: torch.Tensor,
    draws: Optional[UCDraws] = None,
) -> Dict[str, torch.Tensor]:
    """One serving pass of a model in training (forward_test in the compute
    dtype, in eval mode, without gradients), as the JAX package's quality
    runs call forward_test on cast_for_compute(params); `draws` gives the
    uncertainty's masks and normals (see FasterRCNN.forward_test)."""
    with eval_mode(model), torch.no_grad():
        return compute_call(model, "forward_test", images, window, draws=draws)


def batch_to_device(batch: Mapping[str, object], device: torch.device) -> Dict[str, object]:
    """A loader batch on `device`: arrays become tensors, tensors (a lidar
    batch's raster, made on the loader's device) move if they are elsewhere,
    scale_idx an int; keys starting with '_' (loader bookkeeping) are
    dropped."""
    out: Dict[str, object] = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        if k == "scale_idx":
            out[k] = int(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device, non_blocking=True)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
    return out


def draw_train_keys(
    model: FasterRCNN, batch: Mapping[str, object], generator: torch.Generator
) -> TrainDraws:
    """The step's random draws for a device batch, from `generator` (which
    lives on the batch's device); with uncertainty a UCDraws on the same
    generator for the step's dropout masks and normals."""
    data, gt = batch["data"], batch["gt_boxes"]
    b, g = gt.shape[:2]
    n, r = model.train_lane_counts(tuple(data.shape[1:3]), g)
    kw = dict(generator=generator, device=data.device)
    noise = torch.randn((b, g, 4), **kw) if model.cfg.train.use_gt_noise else None
    uc = UCDraws(generator) if uses_uncertainty(model.cfg) else None
    return TrainDraws(
        torch.rand((b, n), **kw), torch.rand((b, n), **kw),
        torch.rand((b, r), **kw), torch.rand((b, r), **kw), noise, uc,
    )


def make_train_step(model: FasterRCNN, optimizer: DetectorSGD) -> Callable:
    """step(batch, draws, proposals=None) -> (detached losses, TrainAux):
    one forward, backward and optimizer update.  `batch` is a device batch
    (batch_to_device); `proposals` pins the second stage to given lanes."""

    def step(batch, draws: TrainDraws, proposals=None):
        optimizer.zero_grad()
        args = (batch["data"], batch["gt_boxes"], batch["gt_mask"], batch["window"], draws)
        kwargs = dict(
            gt_boxes_dc=batch.get("gt_boxes_dc"), dc_mask=batch.get("dc_mask"),
            scale_idx=batch.get("scale_idx"), proposals=proposals,
        )
        losses, aux = compute_call(model, "forward_train", *args, **kwargs)
        losses["total_loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}, aux

    return step


def train(
    model: FasterRCNN,
    optimizer: DetectorSGD,
    loader,
    iters: int,
    generator: torch.Generator,
    on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None,
) -> Dict[str, List]:
    """Run `iters` steps: loader batch -> H2D -> draws -> step.  Each step
    is timed from the H2D copy to the end of the update (CUDA events on a
    card, the host clock on the CPU).  Returns per-step float losses and
    milliseconds; on_step(i, losses, ms) is called after each step.  The
    model is put in train mode."""
    device = model_device(model)
    model.train()
    step = make_train_step(model, optimizer)
    timer = DeviceTimer(device)
    all_losses, all_ms = [], []
    for i in range(iters):
        host = loader.next()
        timer.start()
        batch = batch_to_device(host, device)
        losses, _ = step(batch, draw_train_keys(model, batch, generator))
        ms = timer.stop()
        losses = {k: float(v) for k, v in losses.items()}
        all_losses.append(losses)
        all_ms.append(ms)
        if on_step is not None:
            on_step(i, losses, ms)
    return {"losses": all_losses, "ms": all_ms}
