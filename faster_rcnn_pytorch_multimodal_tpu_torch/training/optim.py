"""SGD with the reference's per-parameter policy.

Port of faster_rcnn_pytorch_multimodal_tpu/training/optim.py.  The JAX
package expresses the policy as masked optax transforms over its parameter
tree; the masks here are the same predicates over the port's torchvision-
style state-dict keys:

  * frozen: the stem (backbone.conv1 / bn1), backbone.layer1..FIXED_BLOCKS
    and every FrozenBatchNorm leaf; the model's frozen parameters get
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
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config

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
    if any(p.startswith("bn") for p in parts) or ".downsample.1." in key:
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


def safe_clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place to a global L2 norm of at most max_norm;
    returns the norm before clipping.

    The norm is taken as m * sqrt(sum((g / m)^2)) with m = max |g|, so it
    cannot overflow float32 for finite gradients (torch's clip_grad_norm_
    squares raw values).  A non-finite norm zeroes every gradient, so the
    step applies only weight decay and momentum, as in the JAX package.
    Deciding that reads the norm on the host: one synchronisation a step.
    """
    m = torch.stack(torch._foreach_norm(grads, float("inf"))).amax()
    safe_m = torch.where(m > 0, m, torch.ones_like(m))
    scaled = torch._foreach_div(grads, safe_m)
    sumsq = torch.stack(torch._foreach_norm(scaled, 2.0)).square().sum()
    norm = safe_m * torch.sqrt(sumsq)
    if not torch.isfinite(norm):
        torch._foreach_zero_(grads)
    else:
        torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


class DetectorSGD:
    """The JAX package's `build_optimizer` chain for one detector (see the
    module docstring).  Constructing it sets requires_grad on the model's
    parameters from the frozen mask."""

    def __init__(self, model: torch.nn.Module, cfg: Config):
        self.cfg = cfg
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
        norm = safe_clip_by_global_norm_([p.grad for p in self.params], self.cfg.grad_max_clip)
        lr = self.schedule(self.step_count)
        for group in self.sgd.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.sgd.step()
        self.step_count += 1
        return norm
