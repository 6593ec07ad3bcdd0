"""SGD with the reference's per-parameter policy.

Port of faster_rcnn_pytorch_multimodal_tpu/training/optim.py.  The JAX
package expresses the policy as masked optax transforms over its parameter
tree; the masks here are the same predicates over the port's torchvision-
style state-dict keys:

  * frozen: the stem (backbone.conv1 / bn1), backbone.layer1..FIXED_BLOCKS
    (MobileNet's first separable layers; VGG16 has no such names, so
    nothing of it is frozen, as in the JAX package) and every
    FrozenBatchNorm leaf; the model's frozen parameters get
    requires_grad=False, so they have no gradient at all;
  * bias: optional 2x learning rate (TRAIN.DOUBLE_BIAS), no weight decay
    unless TRAIN.BIAS_DECAY;
  * the chain order of optax: global-norm clip -> masked weight decay ->
    2x bias -> SGD momentum at the scheduled learning rate.

`DetectorSGD` runs the clip, then torch.optim.SGD with one parameter group
per (decay, double-bias) pair: SGD adds weight_decay * p to the gradient
before its momentum buffer, as the decay precedes optax's trace, and a
group's 2x learning rate equals scaling its gradient by 2 before the
buffer, since both are linear.  tests/test_torch_port_targets.py holds it
against the optax chain.

In a data-parallel run (`dp`) each rank's gradients are those of its share
of the global loss; `step` sums them over the data group
(parallel.all_reduce_grads_, one flat bucket) before the clip, so the clip
sees the global gradient's norm and every rank applies the same update, as
JAX's SPMD step does.  On a model axis a sharded leaf's gradient is its
shard's and a replicated leaf's is the same on every rank of the model
group: both sum over the data group; a backbone leaf whose step ran on row
slabs (parallel.spatial) holds its slab's part and sums over every rank.
The clip's norm counts a replicated leaf once and sums the sharded leaves'
squares over the model group.  Momentum buffers live with their leaves'
shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.mesh import DataParallel, all_reduce_grads_
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer, span

_BN_STATS = ("running_mean", "running_var")
_STEM = ("conv1", "bn1")


def is_frozen(key: str, cfg: Config) -> bool:
    """True where the parameter must not train."""
    parts = key.split(".")
    if parts[-1] in _BN_STATS:
        return True
    fixed = cfg.resnet.fixed_blocks
    if fixed < 0:
        return False  # train everything but the BN statistics
    in_backbone = parts[0] == "backbone"
    if in_backbone and parts[1] in _STEM:
        return True
    # every FrozenBatchNorm: a ResNet block's bn1..3 and downsample BN, and
    # MobileNet's bn0, dw_bn and pw_bn (JAX matches names ending in `_bn`)
    if any(p.startswith("bn") or p.endswith("_bn") for p in parts) or ".downsample.1." in key:
        return True
    return in_backbone and parts[1] in {f"layer{i}" for i in range(1, fixed + 1)}


def is_bias(key: str) -> bool:
    return key.rsplit(".", 1)[-1] == "bias"


def wants_decay(key: str, cfg: Config) -> bool:
    return not is_frozen(key, cfg) and (cfg.train.bias_decay or not is_bias(key))


def frozen_mask(keys: Iterable[str], cfg: Config) -> Dict[str, bool]:
    return {k: is_frozen(k, cfg) for k in keys}


def bias_mask(keys: Iterable[str]) -> Dict[str, bool]:
    return {k: is_bias(k) for k in keys}


def decay_mask(keys: Iterable[str], cfg: Config) -> Dict[str, bool]:
    return {k: wants_decay(k, cfg) for k in keys}


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Step decay with optax.piecewise_constant_schedule's semantics: the
    rate at update `count` (from 0) is LEARNING_RATE times GAMMA for every
    STEPSIZE boundary <= count, multiplied in float32 as optax does."""
    boundaries = sorted({int(s): cfg.train.gamma for s in cfg.train.stepsize}.items())
    base = np.float32(cfg.train.learning_rate)

    def lr(count: int) -> float:
        v = base
        for boundary, scale in boundaries:
            if count >= boundary:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return lr


def safe_clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                              sharded: Optional[List[bool]] = None,
                              dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Scale `grads` in place to a global L2 norm of at most max_norm;
    returns the norm before clipping.

    The norm is taken as m * sqrt(sum((g / m)^2)) with m = max |g|, so it
    cannot overflow float32 for finite gradients (torch's clip_grad_norm_
    squares raw values).  A non-finite norm zeroes every gradient, so the
    step applies only weight decay and momentum, as in the JAX package.
    Deciding that reads the norm on the host: one synchronisation a step.
    With `sharded` (a flag a leaf: a shard of a leaf split over `dp`'s model
    group) m is the maximum over the model group and the sharded leaves'
    squares sum over it, the others' count once: every rank gets the norm
    of the whole gradient.
    """
    m = torch.stack(torch._foreach_norm(grads, float("inf"))).amax()
    if sharded is not None:
        m = mesh.all_reduce_(m.clone(), dp, "model", op=dist.ReduceOp.MAX)
    safe_m = torch.where(m > 0, m, torch.ones_like(m))
    scaled = torch._foreach_div(grads, safe_m)
    squares = torch.stack(torch._foreach_norm(scaled, 2.0)).square()
    if sharded is None:
        sumsq = squares.sum()
    else:
        split = torch.tensor(sharded, device=squares.device)
        sumsq = (mesh.all_reduce_(squares[split].sum(), dp, "model")
                 + squares[~split].sum())
    norm = safe_m * torch.sqrt(sumsq)
    with span("sync.clip_norm"):
        finite = bool(torch.isfinite(norm))
    if not finite:
        torch._foreach_zero_(grads)
    else:
        torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


class DetectorSGD:
    """The JAX package's `build_optimizer` chain for one detector (see the
    module docstring).  Constructing it sets requires_grad on the model's
    parameters from the frozen mask.  With `dp` (a rank of a data-parallel
    run) each step sums the gradients over the ranks first; `last_reduce_ms` holds
    that all-reduce's time (CUDA events on a card), else None."""

    def __init__(self, model: torch.nn.Module, cfg: Config, dp: Optional[DataParallel] = None):
        self.cfg = cfg
        self.dp = dp
        self.model = model
        self.last_reduce_ms: Optional[float] = None
        self.schedule = lr_schedule(cfg)
        self.step_count = 0
        groups: Dict[tuple, List[torch.nn.Parameter]] = {}
        for name, p in model.named_parameters():
            frozen = is_frozen(name, cfg)
            p.requires_grad_(not frozen)
            if not frozen:
                key = (wants_decay(name, cfg), cfg.train.double_bias and is_bias(name))
                groups.setdefault(key, []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        names = {p: k for k, p in model.named_parameters()}
        self.names = [names[p] for p in self.params]
        self.sgd = torch.optim.SGD(
            [
                {"params": ps, "weight_decay": cfg.train.weight_decay if decay else 0.0,
                 "lr_scale": 2.0 if double else 1.0}
                for (decay, double), ps in groups.items()
            ],
            lr=self.schedule(0),
            momentum=cfg.train.momentum,
        )

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, decay and update; returns the gradient norm before
        clipping.  A trainable parameter without a gradient counts as a
        zero gradient (it still decays), as jax.grad returns zeros."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        sharded = None
        if self.dp is not None:
            timer = DeviceTimer(self.dp.device)
            timer.start()
            if self.dp.model == 1:
                all_reduce_grads_(grads, self.dp)
            else:
                dims = getattr(self.model, "shard_dims", None) or {}
                sharded = [k in dims for k in self.names]
                # the backbone's leaves hold their row slab's part of the gradient
                slabs = [getattr(self.model, "rows_split", False)
                         and k.startswith("backbone.") for k in self.names]
                all_reduce_grads_([g for g, s in zip(grads, slabs) if not s], self.dp, "data")
                all_reduce_grads_([g for g, s in zip(grads, slabs) if s], self.dp, "all")
            self.last_reduce_ms = timer.stop()
        norm = safe_clip_by_global_norm_(grads, self.cfg.grad_max_clip, sharded, self.dp)
        lr = self.schedule(self.step_count)
        for group in self.sgd.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.sgd.step()
        self.step_count += 1
        return norm

    def state_dict(self) -> Dict:
        """The momentum buffers and the update count that drives the
        schedule (the JAX package's TrainState.opt_state and step)."""
        return {"sgd": self.sgd.state_dict(), "step_count": self.step_count}

    def load_state_dict(self, state: Dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.step_count = int(state["step_count"])
