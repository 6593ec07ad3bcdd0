"""The RoI tail's channels over the model axis (MESH.MODEL m > 1): the port
of JAX's param_shardings (parallel/mesh.py:117-143).

The rule, on the port's state-dict keys (`shard_dims`):
  * `tail.*` (ResNetLayer4, FCTail, VGG16Tail, MobileNetV1Tail): every
    channel dimension: a conv weight (OIHW; JAX's HWIO on O) and a Linear
    weight ((out, in); JAX's (I, O) on O) on dim 0, a depthwise kernel
    ((C, 1, 3, 3); JAX's (3, 3, 1, C) on C) on dim 0, every per-channel
    vector (bias, BN scale, bias, statistics) on dim 0;
  * `predictors.*` 2-D weights on their input, dim 1 (JAX's (I, O) on I):
    row parallel, each adds its bias once after the sum;
  * everything else whole on every rank.
JAX leaves a leaf whose dimension does not divide by m whole; here the tail
is sharded whole or not at all (a tail with such a leaf stays whole on
every rank, and `shard_model_` says so), since its layers pass shards to
each other; a predictor kernel's input dimension is taken leaf by leaf.
Every tail dimension of the ported nets divides at m = 2 and 4.

The tail's layers then compute a rank's 1/m of their output channels from
their whole input (column parallel): `column_input` gathers a shard whole
where the next layer contracts over the channels and enters it through
mesh.copy_to_model, whose backward sums the ranks' partial input
gradients; a depthwise conv takes its channels' shard (`depthwise_input`);
the residual add, BN, ReLU, dropout (the rank's channels of the whole
mask) and the spatial mean before the predictors run on the rank's shard;
`row_linear` takes the predictors' sharded input and sums the partial
products over the model group (mesh.reduce_from_model), so the outputs
come out whole on every rank.  Where nothing is sharded each helper is the
identity.

Snapshots and preloads see whole state dicts: `shard_state_dict` /
`gather_state_dict` (pure), `shard_model_` / `unshard_model_` (in place,
on a rank, the optimizer's momentum buffers with their leaves).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh

ROW_PARALLEL = "predictors"
COLUMN_PARALLEL = "tail"


def shard_dims(shapes: Mapping[str, Sequence[int]], m: int) -> Dict[str, Optional[int]]:
    """The dimension each leaf (state-dict key -> whole shape) shards on
    over a model axis of m, or None where it stays whole."""
    dims: Dict[str, Optional[int]] = {}
    tail_whole = False
    for k, shape in shapes.items():
        root = k.split(".", 1)[0]
        d = None
        if m > 1 and root == COLUMN_PARALLEL and len(shape) in (1, 2, 4):
            d = 0
            tail_whole |= shape[0] % m != 0
        elif m > 1 and root == ROW_PARALLEL and len(shape) == 2 and shape[1] % m == 0:
            d = 1
        dims[k] = d
    if tail_whole:
        dims.update({k: None for k in dims if k.split(".", 1)[0] == COLUMN_PARALLEL})
    return dims


def _part(t: torch.Tensor, d: int, j: int, m: int) -> torch.Tensor:
    n = t.shape[d] // m
    return t.narrow(d, j * n, n).contiguous(memory_format=mesh._memory_format(t))


def shard_state_dict(full: Mapping[str, torch.Tensor], model_index: int, m: int
                     ) -> Dict[str, torch.Tensor]:
    """Rank `model_index`'s leaves of a whole state dict (shard_dims)."""
    dims = shard_dims({k: v.shape for k, v in full.items()}, m)
    return {k: v if dims[k] is None else _part(v, dims[k], model_index, m)
            for k, v in full.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The whole state dict from the model ranks' shards (by model index)
    and the dims they were sharded on (shard_dims of the whole shapes):
    shard_state_dict's inverse."""
    return {k: v if dims.get(k) is None else torch.cat([s[k] for s in shards], dim=dims[k])
            for k, v in shards[0].items()}


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "shard_dims", None) is not None


def _momentum(model: nn.Module, optimizer) -> Dict[str, dict]:
    """{parameter key: its SGD state} of the optimizer (a DetectorSGD)."""
    if optimizer is None:
        return {}
    state = optimizer.sgd.state
    return {k: state[p] for k, p in model.named_parameters() if p in state}


def _buffers(model: nn.Module):
    for mod_name, mod in model.named_modules():
        for name, b in mod._buffers.items():
            if b is not None:
                yield (f"{mod_name}.{name}" if mod_name else name), mod, name, b


def _fit_tail(model: nn.Module, shard) -> None:
    """The tail's layers after its leaves were sharded (shard (j, m)) or
    gathered (None): a depthwise conv's groups are its channels, a dropout
    layer cuts the whole mask to shard j of m of its channels."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import CheapDropout

    for mod in model.tail.modules():
        if isinstance(mod, nn.Conv2d) and mod.groups > 1:
            mod.groups = mod.weight.shape[0]
        elif isinstance(mod, CheapDropout):
            mod.channel_shard = shard


def shard_model_(model: nn.Module, dp: mesh.DataParallel, optimizer=None) -> Dict[str, int]:
    """Keep this rank's shards of the model's whole leaves (and of the
    optimizer's momentum buffers), in place: the Parameter objects stay, so
    an optimizer built before holds them.  Returns {key: dim} of what was
    sharded."""
    if is_sharded(model):
        raise RuntimeError("shard_model_: the model is sharded already")
    m, j = dp.model, dp.model_rank
    dims = shard_dims({k: v.shape for k, v in model.state_dict().items()}, m)
    momentum = _momentum(model, optimizer)
    with torch.no_grad():
        for k, p in model.named_parameters():
            d = dims[k]
            if d is None:
                continue
            p.data = _part(p.data, d, j, m)
            buf = momentum.get(k, {}).get("momentum_buffer")
            if buf is not None:
                momentum[k]["momentum_buffer"] = _part(buf, d, j, m)
        for k, mod, name, b in list(_buffers(model)):
            if dims.get(k) is not None:
                mod._buffers[name] = _part(b, dims[k], j, m)
    sharded = {k: d for k, d in dims.items() if d is not None}
    tail = any(k.startswith(COLUMN_PARALLEL + ".") for k in sharded)
    _fit_tail(model, (j, m) if tail else None)
    if not tail and dp.is_main:
        print(f"model axis: a channel of the tail does not divide by MESH.MODEL {m}: the tail "
              "stays whole on every rank", flush=True)
    model.shard_dims = sharded
    return sharded


def unshard_model_(model: nn.Module, dp: mesh.DataParallel, optimizer=None) -> None:
    """shard_model_'s inverse: the whole leaves (and momentum buffers) on
    every rank of the model group, gathered in place.  A collective."""
    dims, m, j = model.shard_dims, dp.model, dp.model_rank
    momentum = _momentum(model, optimizer)

    def whole(t, d):
        n = t.shape[d]
        return mesh._slots(t, d, j * n, n * m, dp, "update")

    with torch.no_grad():
        for k, p in model.named_parameters():
            if k in dims:
                p.data = whole(p.data, dims[k])
                buf = momentum.get(k, {}).get("momentum_buffer")
                if buf is not None:
                    momentum[k]["momentum_buffer"] = whole(buf, dims[k])
        for k, mod, name, b in list(_buffers(model)):
            if k in dims:
                mod._buffers[name] = whole(b, dims[k])
    _fit_tail(model, None)
    model.shard_dims = None


def tail_bytes(model: nn.Module) -> int:
    """The bytes of the tail's parameters and buffers on this rank."""
    return sum(t.numel() * t.element_size() for k, t in model.state_dict().items()
               if k.startswith(COLUMN_PARALLEL + "."))


# -- the tail's layers ----------------------------------------------------------------


def _widths(layer: nn.Module):
    """(whole input width, whole output width) of a conv or Linear."""
    if isinstance(layer, nn.Linear):
        return layer.in_features, layer.out_features
    return layer.in_channels, layer.out_channels


def _whole(x: torch.Tensor, width: int) -> torch.Tensor:
    """x whole along its channels: gathered where it is this rank's shard."""
    if x.shape[1] == width:
        return x
    dp = mesh.model_axis()
    return mesh.gather_model(x, 1, dp.model_rank * x.shape[1], width)


def column_input(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """x (N, C, ...) as a layer that contracts over its channels (a conv
    or a Linear) takes it: whole, and, where the layer holds this rank's
    part of its outputs, entered through copy_to_model."""
    cin, cout = _widths(layer)
    x = _whole(x, cin)
    if layer.weight.shape[0] != cout:
        x = mesh.copy_to_model(x)
    return x


def own_channels(x: torch.Tensor, width: int) -> torch.Tensor:
    """This rank's `width` channels of x (a residual beside a sharded
    branch), or x where it is that wide."""
    if x.shape[1] == width:
        return x
    return x.narrow(1, mesh.model_axis().model_rank * width, width)


def depthwise_input(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """x as a depthwise conv takes it: this rank's channels where the conv
    holds a shard of them (split_model: the backward gathers), else whole."""
    n = conv.weight.shape[0]
    if n == conv.out_channels:
        return _whole(x, conv.in_channels)
    if x.shape[1] == n:
        return x
    return mesh.split_model(x, 1, mesh.model_axis().model_rank * n, n)


def row_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """lin(x) for a predictor: where lin holds this rank's rows of its input
    (row parallel) the product of x's shard, summed over the model group,
    plus the bias once; else lin of the whole x."""
    n = lin.weight.shape[1]
    if n == lin.in_features:
        return lin(_whole(x, n))
    if x.shape[1] != n:
        x = mesh.split_model(x, 1, mesh.model_axis().model_rank * n, n)
    y = mesh.reduce_from_model(F.linear(x, lin.weight))
    return y if lin.bias is None else y + lin.bias
