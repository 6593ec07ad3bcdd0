"""Weight bridge between the JAX package's flax parameters and the port.

`from_flax_variables` turns the JAX FasterRCNN's variables (numpy leaves)
into the port's state dict; `to_flax_variables` goes back.  Conversions:

  conv kernel (kH, kW, I, O)     <-> weight (O, I, kH, kW)
  dense kernel (I, O)            <-> weight (O, I)
  BN scale / bias / mean / var   <-> weight / bias / running_mean / running_var

The port's backbone and tail are named after torchvision's ResNet keys, so
the flax path of a backbone key is exactly what `resnet_key_to_flax` gives,
a copy of the JAX package's utils/convert.py:49-86.  The root tells the two
models apart: layer4 lives under 'tail' in C4 and under 'backbone' in the
FPN model, whose 'fpn' (latlayer2..5, aalayer2..4) and FCTail
('tail/t_fc1..3') map like the heads.  BasicBlock (res18/34) keys are
Bottleneck's without conv3/bn3: conv1/conv2/bn1/bn2/downsample.  With live
BN (FIXED_BLOCKS -1) the JAX package keeps the BN statistics in the
`batch_stats` collection (.../bn1/mean, var) and only scale and bias under
`params`; they map to running_mean / running_var all the same.

Uncertainty adds the RPN's variance convs at the root
(rpn_bbox_al_var_net, rpn_cls_al_var_net), the predictors' cls_al_var_net
and bbox_al_var_net, and the epistemic stacks, which flax names
EpistemicStack_0 and _1 in the order they are built (the class stack first
when there is one) and the port cls_stack and bbox_stack:
predictors/EpistemicStack_i/cls_fc1/kernel <-> predictors.cls_stack.cls_fc1.weight.
A stack's BN (lidar) is a frozen one: its statistics stay under `params`
even with live BN.  Every leaf
must map, in both directions: an unknown path or key raises.  Shapes carry
over as they are, so a LiDAR net's 15-channel stem and 7K-wide box head
convert like the image net's.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_BN_TO_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BN_TO_FLAX = {v: k for k, v in _BN_TO_TORCH.items()}
_HEADS = {
    "rpn": ("rpn_net", "rpn_cls_score_net", "rpn_bbox_pred_net"),
    "predictors": ("cls_score_net", "bbox_pred_net", "cls_al_var_net", "bbox_al_var_net"),
    "fpn": ("latlayer2", "latlayer3", "latlayer4", "latlayer5", "aalayer2", "aalayer3", "aalayer4"),
    "tail": ("t_fc1", "t_fc2", "t_fc3"),
}
_ROOT_CONVS = ("rpn_bbox_al_var_net", "rpn_cls_al_var_net")
_STACK_LAYER = re.compile(r"(cls|bbox)_(fc|bn)[12]")


def _is_stack_path(path: Tuple[str, ...]) -> bool:
    return len(path) > 1 and path[0] == "predictors" and path[1].startswith("EpistemicStack_")


def resnet_key_to_flax(key: str, use_fpn: bool) -> Tuple[str, ...] | None:
    """torchvision ResNet key -> the JAX package's param path (under
    'backbone' / the C4 'tail').  None for keys it drops (fc head,
    trackers)."""
    if "num_batches_tracked" in key or key.startswith("fc."):
        return None
    key = key.replace("resnet.", "")
    m = re.match(r"^(conv1|bn1)\.(\w+)$", key)
    if m:
        mod, leaf = m.groups()
        if mod == "conv1":
            return ("backbone", "stem", "conv1", "kernel")
        return ("backbone", "stem", "bn1", _BN_TO_FLAX[leaf])
    m = re.match(r"^layer(\d)\.(\d+)\.(conv\d|bn\d|downsample)\.?(\d+)?\.(\w+)$", key)
    if not m:
        m2 = re.match(r"^layer(\d)\.(\d+)\.(conv\d|bn\d)\.(\w+)$", key)
        if not m2:
            return None
        stage, block, mod, leaf = m2.groups()
        ds_idx = None
    else:
        stage, block, mod, ds_idx, leaf = m.groups()
    stage_i, block_i = int(stage), int(block)
    # layer4 lives in the C4 tail; under FPN it is in the pyramid backbone
    root = ("tail",) if (stage_i == 4 and not use_fpn) else ("backbone",)
    scope = root + (f"layer{stage_i}", f"block{block_i}")
    if mod == "downsample":
        name = "downsample_conv" if ds_idx == "0" else "downsample_bn"
        leaf_name = "kernel" if name == "downsample_conv" else _BN_TO_FLAX[leaf]
        return scope + (name, leaf_name)
    if mod.startswith("conv"):
        return scope + (mod, "kernel")
    return scope + (mod, _BN_TO_FLAX[leaf])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """('backbone', 'layer1', 'block0', 'conv1', 'kernel') -> 'backbone.layer1.0.conv1.weight'."""
    root, rest = path[0], path[1:]
    if root in _HEADS and len(rest) == 2 and rest[0] in _HEADS[root]:
        leaf = {"kernel": "weight", "bias": "bias"}[rest[1]]
        return f"{root}.{rest[0]}.{leaf}"
    if root in _ROOT_CONVS and len(rest) == 1 and rest[0] in ("kernel", "bias"):
        return f"{root}.{'weight' if rest[0] == 'kernel' else 'bias'}"
    if _is_stack_path(path) and len(rest) == 3:
        m = _STACK_LAYER.fullmatch(rest[1])
        if m is not None:
            bn_map = _BN_TO_TORCH if m.group(2) == "bn" else {"kernel": "weight", "bias": "bias"}
            if rest[2] in bn_map:
                return f"predictors.{m.group(1)}_stack.{rest[1]}.{bn_map[rest[2]]}"
    if root in ("backbone", "tail"):
        if rest[0] == "stem" and len(rest) == 3:
            mod, leaf = rest[1], rest[2]
            key = f"{mod}.{'weight' if leaf == 'kernel' else _BN_TO_TORCH[leaf]}"
        else:
            m = re.fullmatch(r"block(\d+)", rest[1]) if len(rest) == 4 else None
            if m is None:
                raise KeyError(f"unmapped flax path {'/'.join(path)}")
            layer, mod, leaf = rest[0], rest[2], rest[3]
            mod = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(mod, mod)
            name = "weight" if leaf == "kernel" else _BN_TO_TORCH[leaf]
            key = f"{layer}.{m.group(1)}.{mod}.{name}"
        # layer4 under 'backbone' is the FPN model's
        if resnet_key_to_flax(key, use_fpn=root == "backbone") != tuple(path):
            raise KeyError(f"unmapped flax path {'/'.join(path)}")
        return f"{root}.{key}"
    raise KeyError(f"unmapped flax path {'/'.join(path)}")


def torch_key_to_flax_path(key: str, cls_stack: bool = True) -> Tuple[str, ...]:
    """Inverse of flax_path_to_torch_key.  `cls_stack`: whether the model
    has a class stack, which takes EpistemicStack_0 before the box stack."""
    root, _, rest = key.partition(".")
    parts = rest.split(".")
    if root in _HEADS and len(parts) == 2 and parts[0] in _HEADS[root]:
        return (root, parts[0], {"weight": "kernel", "bias": "bias"}[parts[1]])
    if root in _ROOT_CONVS and parts in (["weight"], ["bias"]):
        return (root, "kernel" if parts[0] == "weight" else "bias")
    if root == "predictors" and len(parts) == 3 and parts[0] in ("cls_stack", "bbox_stack"):
        m = _STACK_LAYER.fullmatch(parts[1])
        kind = parts[0][: -len("_stack")]
        if m is not None and m.group(1) == kind:
            bn_map = _BN_TO_FLAX if m.group(2) == "bn" else {"weight": "kernel", "bias": "bias"}
            if parts[2] in bn_map:
                i = 1 if kind == "bbox" and cls_stack else 0
                return ("predictors", f"EpistemicStack_{i}", parts[1], bn_map[parts[2]])
    if root in ("backbone", "tail"):
        path = resnet_key_to_flax(rest, use_fpn=root == "backbone")
        if path is None or path[0] != root:
            raise KeyError(f"unmapped torch key {key}")
        return path
    raise KeyError(f"unmapped torch key {key}")


def _to_torch_layout(v: np.ndarray) -> np.ndarray:
    if v.ndim == 4:  # HWIO -> OIHW
        return np.transpose(v, (3, 2, 0, 1))
    if v.ndim == 2:  # IO -> OI
        return v.T
    return v


def _to_flax_layout(v: np.ndarray) -> np.ndarray:
    if v.ndim == 4:  # OIHW -> HWIO
        return np.transpose(v, (2, 3, 1, 0))
    if v.ndim == 2:
        return v.T
    return v


_STATS = ("mean", "var")


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX FasterRCNN variables ({'params': ...[, 'batch_stats': ...]} or
    the params tree itself, numpy-convertible leaves) -> the port's float32
    state dict.  With a `batch_stats` collection (live BN) every BN
    statistic must come from it: a mean or var leaf under `params`, or any
    other leaf under `batch_stats`, raises."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats") if "params" in variables else None
    leaves = [(path, v, False) for path, v in _flatten(params).items()]
    if stats is not None:
        leaves += [(path, v, True) for path, v in _flatten(stats).items()]
    sd = {}
    for path, v, is_stat in leaves:
        if stats is not None and (path[-1] in _STATS and not _is_stack_path(path)) != is_stat:
            where = "batch_stats" if is_stat else "params"
            raise KeyError(f"flax path {'/'.join(path)} under {where} with live BN")
        key = flax_path_to_torch_key(path)
        if key in sd:
            raise KeyError(f"flax path {'/'.join(path)} maps onto {key} twice")
        sd[key] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(v), dtype=np.float32))
    return sd


def to_flax_variables(state_dict: Mapping[str, torch.Tensor], live_bn: bool = False) -> Dict:
    """The port's state dict -> {'params': tree} of float32 numpy leaves;
    with live_bn the BN statistics go to {'batch_stats': tree} instead, as
    the JAX package lays out a FIXED_BLOCKS -1 model (but a stack BN's)."""
    flat, stats = {}, {}
    cls_stack = any(k.startswith("predictors.cls_stack.") for k in state_dict)
    for key, v in state_dict.items():
        arr = v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        path = torch_key_to_flax_path(key, cls_stack)
        to = stats if live_bn and path[-1] in _STATS and not _is_stack_path(path) else flat
        to[path] = np.ascontiguousarray(_to_flax_layout(arr))
    out = {"params": _unflatten(flat)}
    if live_bn:
        out["batch_stats"] = _unflatten(stats)
    return out


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load JAX variables into a port module; raises on any leaf left
    unmapped on either side (strict load)."""
    model.load_state_dict(from_flax_variables(variables), strict=True)


def load_torchvision_resnet(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> int:
    """Load a torchvision ResNet state dict into a FasterRCNN: the backbone
    and the C4 tail (layer4), or under FPN the pyramid backbone, which holds
    layer4 (the FPN and its FCTail keep their init).  The ImageNet fc head
    is dropped.  Returns the number of tensors loaded; raises if a backbone
    or C4 tail tensor is missing."""
    fpn = model.cfg.use_fpn
    backbone, tail = {}, {}
    for k, v in state_dict.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        (tail if k.startswith("layer4.") and not fpn else backbone)[k] = v
    model.backbone.load_state_dict(backbone, strict=True)
    if not fpn:
        model.tail.load_state_dict(tail, strict=True)
    return len(backbone) + len(tail)
