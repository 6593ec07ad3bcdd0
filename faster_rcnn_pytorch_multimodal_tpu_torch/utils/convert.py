"""Weight bridge between the JAX package's flax parameters and the port, and
the converters from torchvision, reference and tf-slim checkpoints.

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

VGG16 and MobileNet keep the JAX package's module names in the port
(backbone.early_conv0..3 / late_conv4..12, tail.fc6 / fc7; backbone.conv0,
bn0, layer1..11 and tail.layer12..13, each layer's depthwise, dw_bn,
pointwise and pw_bn), so their paths map name for name.  fc6's kernel rows
are in (y, x, c) order on both sides (the port flattens each pooled RoI in
NHWC order), so its weight is the kernel transposed; a depthwise kernel is
flax (3, 3, 1, C) against torch (C, 1, 3, 3), the same HWIO <-> OIHW
transpose.  MobileNet's BN statistics stay under `params` at every
FIXED_BLOCKS, as its BN is never live.

Converters into a port model, copies of the JAX package's
utils/convert.py:88-178, :217-249, :313-446 (pure numpy): the torchvision
VGG16 keys (`vgg16_key_to_flax`, with fc6's CHW -> HWC row permutation,
`convert_vgg16_tensor`), the reference MobileNet keys
(`mobilenet_key_to_flax`), each loaded by `load_*_state_dict` as the JAX
package's `_copy_state_dict` loads a flax tree (unmapped keys, absent paths
and other shapes skipped); a torchvision ResNet state dict loads strictly,
key for key (`load_torchvision_resnet`); `replicate_conv1_for_lidar`, the RGB stem
bootstrap of a BEV stem; and the tf-slim renames `tf_slim_{resnet,vgg,
mobilenet}_to_torch`.
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
_VGG_CONV = re.compile(r"(early|late)_conv\d+")
_MOBILE_LAYER = re.compile(r"layer\d+")
_MOBILE_SEP = ("depthwise", "pointwise", "dw_bn", "pw_bn")
_PLAIN_BN = ("bn0", "dw_bn", "pw_bn")
_DENSE_TO_TORCH = {"kernel": "weight", "bias": "bias"}


def _is_plain_module(root: str, mods) -> bool:
    """A VGG16 or MobileNet module: named alike in both packages."""
    mods = tuple(mods)
    if root == "backbone" and len(mods) == 1:
        return bool(_VGG_CONV.fullmatch(mods[0])) or mods[0] in ("conv0", "bn0")
    if root == "tail" and len(mods) == 1:
        return mods[0] in ("fc6", "fc7")
    return (root in ("backbone", "tail") and len(mods) == 2
            and bool(_MOBILE_LAYER.fullmatch(mods[0])) and mods[1] in _MOBILE_SEP)


def _plain_leaf_map(mods) -> Dict[str, str]:
    return _BN_TO_TORCH if mods[-1] in _PLAIN_BN else _DENSE_TO_TORCH


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
    if _is_plain_module(root, rest[:-1]) and rest[-1] in _plain_leaf_map(rest[:-1]):
        return ".".join((root,) + rest[:-1] + (_plain_leaf_map(rest[:-1])[rest[-1]],))
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
    if _is_plain_module(root, parts[:-1]):
        leaves = {v: k for k, v in _plain_leaf_map(parts[:-1]).items()}
        if parts[-1] in leaves:
            return (root,) + tuple(parts[:-1]) + (leaves[parts[-1]],)
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


# -- torchvision and reference checkpoints into a port model ---------------------------


def _t(x) -> np.ndarray:
    try:
        return x.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(x)


def convert_tensor(key: str, value) -> np.ndarray:
    """A torch tensor in the JAX package's layout (JAX utils/convert.py:32-38)."""
    return _to_flax_layout(_t(value))


# torchvision vgg16 `features` indices of the 13 convs, in order
_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def vgg16_key_to_flax(key: str) -> Tuple[str, ...] | None:
    """torchvision vgg16 state-dict key -> the JAX package's param path:
    features.<i> convs are early_conv0..3 / late_conv4..12, classifier.0
    and .3 are fc6 and fc7; the 1000-way classifier.6 is dropped."""
    m = re.match(r"^features\.(\d+)\.(weight|bias)$", key)
    if m:
        idx, leaf = int(m.group(1)), m.group(2)
        if idx not in _VGG_CONV_IDX:
            return None
        conv_i = _VGG_CONV_IDX.index(idx)
        scope = "early" if conv_i < 4 else "late"
        return ("backbone", f"{scope}_conv{conv_i}", "kernel" if leaf == "weight" else "bias")
    m = re.match(r"^classifier\.(0|3)\.(weight|bias)$", key)
    if m:
        fc = "fc6" if m.group(1) == "0" else "fc7"
        return ("tail", fc, "kernel" if m.group(2) == "weight" else "bias")
    return None


def convert_vgg16_tensor(key: str, value) -> np.ndarray:
    """convert_tensor, but classifier.0 (fc6) flattens torch's (512, 7, 7)
    CHW RoI where the tail flattens HWC: its rows are permuted, not only
    transposed."""
    v = _t(value)
    if key == "classifier.0.weight":
        return np.transpose(v.reshape(4096, 512, 7, 7), (2, 3, 1, 0)).reshape(7 * 7 * 512, 4096)
    return convert_tensor(key, v)


def mobilenet_key_to_flax(key: str) -> Tuple[str, ...] | None:
    """Reference MobileNet state-dict key (Sequential end points
    Conv2d_0 / Conv2d_<i>.{depthwise,pointwise}.{0: conv, 1: bn}, under
    'mobilenet.' or 'features.') -> the JAX package's param path: layers
    0-11 in the backbone, 12-13 in the tail."""
    if "num_batches_tracked" in key:
        return None
    key = key.replace("mobilenet.", "").replace("features.", "")
    m = re.match(r"^Conv2d_0\.(0|1)\.(\w+)$", key)
    if m:
        sub, leaf = m.groups()
        if sub == "0":
            return ("backbone", "conv0", "kernel")
        return ("backbone", "bn0", _BN_TO_FLAX[leaf])
    m = re.match(r"^Conv2d_(\d+)\.(depthwise|pointwise)\.(0|1)\.(\w+)$", key)
    if not m:
        return None
    i, which, sub, leaf = int(m.group(1)), m.group(2), m.group(3), m.group(4)
    scope = ("backbone" if i <= 11 else "tail", f"layer{i}")
    if sub == "0":
        return scope + (which, "kernel")
    return scope + ("dw_bn" if which == "depthwise" else "pw_bn", _BN_TO_FLAX[leaf])


def replicate_conv1_for_lidar(
    state_dict: Mapping, num_slices: int, num_channel: int, key: str = "conv1.weight"
) -> Dict:
    """An RGB stem conv -> a BEV stem of num_channel inputs (the reference's
    lidarnet.py load_imagenet_pretrained_cnn): the R kernel replicated over
    the num_slices height slices, G and B in the first two meta channels,
    any further channel zero.  `key` names the stem's weight (a torchvision
    ResNet's by default; the port's own checkpoints name theirs
    backbone.conv1 / early_conv0 / conv0).  The new weight is a float32
    numpy array."""
    out = dict(state_dict)
    w = _t(state_dict[key])  # (O, 3, kh, kw)
    new = np.zeros((w.shape[0], num_channel, w.shape[2], w.shape[3]), np.float32)
    new[:, :num_slices] = np.repeat(w[:, :1], num_slices, axis=1)
    if num_channel > num_slices:
        new[:, num_slices] = w[:, 1]
    if num_channel > num_slices + 1:
        new[:, num_slices + 1] = w[:, 2]
    out[key] = new
    return out


def _copy_state_dict(model: torch.nn.Module, state_dict: Mapping, key_fn, tensor_fn,
                     verbose: bool = False) -> int:
    """Copy the tensors of `state_dict` into the port model, each through
    key_fn (its JAX path) and tensor_fn (its JAX layout), as the JAX
    package's _copy_state_dict copies them into a flax tree: keys with no
    path, paths the model lacks and tensors of another shape are skipped
    (printed when verbose).  Returns the number copied."""
    own = model.state_dict()
    new = {}
    for key, value in state_dict.items():
        path = key_fn(key)
        if path is None:
            continue
        try:
            tkey = flax_path_to_torch_key(path)
        except KeyError:
            tkey = None
        if tkey not in own:
            if verbose:
                print(f"skip {key} -> {'/'.join(path)} (absent)")
            continue
        v = _to_torch_layout(tensor_fn(key, value))
        if tuple(own[tkey].shape) != v.shape:
            if verbose:
                print(f"skip {key}: shape {v.shape} vs {tuple(own[tkey].shape)}")
            continue
        new[tkey] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    model.load_state_dict(new, strict=False)
    return len(new)


def load_vgg16_state_dict(model: torch.nn.Module, state_dict: Mapping,
                          verbose: bool = False) -> int:
    """A torchvision vgg16 state dict into a port VGG16 FasterRCNN (the 13
    convs, fc6 with its rows permuted to (y, x, c), fc7)."""
    return _copy_state_dict(model, state_dict, vgg16_key_to_flax, convert_vgg16_tensor, verbose)


def load_mobilenet_state_dict(model: torch.nn.Module, state_dict: Mapping,
                              verbose: bool = False) -> int:
    """A reference-layout MobileNet state dict into a port MobileNet
    FasterRCNN; a torch depthwise kernel (C, 1, 3, 3) is the port's layout
    as it is."""
    return _copy_state_dict(model, state_dict, mobilenet_key_to_flax, convert_tensor, verbose)


# -- tf-faster-rcnn (tf-slim) checkpoints ------------------------------------------------


def _ordered_replace(var_dict: Dict, replacements) -> Dict:
    """The reference's ordered in-place key rewrites."""
    for a, b in replacements:
        for k in list(var_dict.keys()):
            if a in k:
                var_dict[k.replace(a, b)] = var_dict.pop(k)
    return var_dict


def _strip_prefix(var_dict: Dict, stem: str) -> Dict:
    out = {}
    for k, v in var_dict.items():
        if k == "Variable" or "Momentum" in k:
            continue  # the global step and the optimizer's slots
        out[stem + k[k.find("/"):] if "/" in k else k] = np.asarray(v)
    return out


def _tf_to_torch_layout(var_dict: Dict, depthwise_hint: bool = False) -> Dict:
    """tf HWIO conv / IO fc -> torch OIHW / OI; a tf depthwise kernel HWC1
    becomes the grouped conv's (C, 1, H, W)."""
    for k in list(var_dict.keys()):
        v = var_dict[k]
        if v.ndim == 4:
            perm = (2, 3, 0, 1) if depthwise_hint and "depthwise" in k else (3, 2, 0, 1)
            var_dict[k] = np.ascontiguousarray(v.transpose(perm))
        elif v.ndim == 2:
            var_dict[k] = np.ascontiguousarray(v.T)
    return var_dict


def tf_slim_resnet_to_torch(var_dict: Mapping) -> Dict:
    """tf-faster-rcnn ResNet variables -> the reference's torch key space
    ('resnet.layerN...' and the head names), numpy values in torch layout;
    the 'resnet.' keys, prefix dropped, are a torchvision ResNet's
    (load_torchvision_resnet)."""
    var_dict = _strip_prefix(dict(var_dict), "resnet")
    _ordered_replace(var_dict, [
        ("moving_mean", "running_mean"),
        ("moving_variance", "running_var"),
        ("weights", "weight"),
        ("biases", "bias"),
        ("conv1/BatchNorm", "bn1"),
        ("conv2/BatchNorm", "bn2"),
        ("conv3/BatchNorm", "bn3"),
        ("bottleneck_v1/", ""),
        ("block", "layer"),
        ("resnet/rpn_conv/3x3", "rpn_net"),
        ("resnet/rpn_cls_score", "rpn_cls_score_net"),
        ("resnet/cls_score", "cls_score_net"),
        ("resnet/rpn_bbox_pred", "rpn_bbox_pred_net"),
        ("resnet/bbox_pred", "bbox_pred_net"),
        ("shortcut/weight", "downsample.0.weight"),
        ("shortcut/BatchNorm", "downsample.1"),
        ("gamma", "weight"),
        ("beta", "bias"),
        ("/", "."),
    ])
    for k in list(var_dict.keys()):  # unit_N -> block N - 1
        m = re.search(r"unit_(\d+)", k)
        if m:
            var_dict[k.replace(m.group(0), str(int(m.group(1)) - 1))] = var_dict.pop(k)
    return _tf_to_torch_layout(var_dict)


def tf_slim_vgg_to_torch(var_dict: Mapping) -> Dict:
    """tf-faster-rcnn VGG16 variables -> torchvision vgg16 keys; fc6's
    (25088, 4096) HWC-flat kernel becomes torch's CHW-flat rows."""
    var_dict = _strip_prefix(dict(var_dict), "vgg")
    _ordered_replace(var_dict, [
        ("weights", "weight"),
        ("biases", "bias"),
        ("vgg/rpn_conv/3x3", "rpn_net"),
        ("vgg/rpn_cls_score", "rpn_cls_score_net"),
        ("vgg/cls_score", "cls_score_net"),
        ("vgg/rpn_bbox_pred", "rpn_bbox_pred_net"),
        ("vgg/bbox_pred", "bbox_pred_net"),
        ("/", "."),
    ])
    _ordered_replace(var_dict, [
        ("conv1.conv1_1", "features.0"), ("conv1.conv1_2", "features.2"),
        ("conv2.conv2_1", "features.5"), ("conv2.conv2_2", "features.7"),
        ("conv3.conv3_1", "features.10"), ("conv3.conv3_2", "features.12"),
        ("conv3.conv3_3", "features.14"), ("conv4.conv4_1", "features.17"),
        ("conv4.conv4_2", "features.19"), ("conv4.conv4_3", "features.21"),
        ("conv5.conv5_1", "features.24"), ("conv5.conv5_2", "features.26"),
        ("conv5.conv5_3", "features.28"),
        ("fc6", "classifier.0"), ("fc7", "classifier.3"),
    ])
    for k in list(var_dict.keys()):
        v = var_dict[k]
        if "classifier.0" in k and v.ndim == 2:
            var_dict[k] = np.ascontiguousarray(
                v.reshape(7, 7, 512, 4096).transpose(3, 2, 0, 1).reshape(4096, -1))
        elif v.ndim == 4:
            var_dict[k] = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        elif v.ndim == 2:
            var_dict[k] = np.ascontiguousarray(v.T)
    return var_dict


def tf_slim_mobilenet_to_torch(var_dict: Mapping) -> Dict:
    """tf-faster-rcnn MobileNetV1 variables -> the reference MobileNet's
    keys (mobilenet_key_to_flax reads them)."""
    var_dict = _strip_prefix(dict(var_dict), "mobilenet")
    _ordered_replace(var_dict, [
        ("moving_mean", "running_mean"),
        ("moving_variance", "running_var"),
        ("weights", "weight"),
        ("biases", "bias"),
        ("/BatchNorm", ".1"),
        ("_pointwise/", ".pointwise.0."),
        ("_depthwise/depthwise_", ".depthwise.0."),
        ("_pointwise.1", ".pointwise.1"),
        ("_depthwise.1", ".depthwise.1"),
        ("Conv2d_0/", "Conv2d_0.0."),
        ("mobilenet/rpn_conv/3x3", "rpn_net"),
        ("mobilenet/rpn_cls_score", "rpn_cls_score_net"),
        ("mobilenet/cls_score", "cls_score_net"),
        ("mobilenet/rpn_bbox_pred", "rpn_bbox_pred_net"),
        ("mobilenet/bbox_pred", "bbox_pred_net"),
        ("gamma", "weight"),
        ("beta", "bias"),
        ("/", "."),
    ])
    return _tf_to_torch_layout(var_dict, depthwise_hint=True)
