"""Process groups: the port of the JAX package's parallel/mesh.py, its
(data x model) mesh (make_mesh, shard_batch, param_shardings).

Rank r of n * m ranks is (data index r // m, model index r % m): JAX's
`reshape(n, m)` of a process-major device list.  The batch shards over the
data axis; the model axis (MESH.MODEL m > 1) shards the RoI tail's channels
(parallel.tensor_parallel) and, with MESH.SPATIAL, the backbone's rows
(parallel.spatial).  A rank's `data_group` holds the ranks of its model
index (they hold different rows of the batch), its `model_group` those of
its data index (they hold the same rows).

JAX's step is one SPMD program over the global batch, so five things are
global there that a naive per-process port would make local:
  * each live batch-norm mean and variance (models.resnet.LiveBatchNorm
    takes them over the global batch through `global_sum`: over the data
    group, or over every rank where the backbone runs on row slabs);
  * each weighted loss's denominator (ops.losses: `sum(nll * w) /
    max(sum(w), 1)` with the global sum of w) and each plain mean (a
    rank's loss is its share of the global loss: the global loss is the
    sum over the data group; the model group holds the same share m times);
  * every random draw (the training step draws the global batch's keys
    and dropout masks from one generator on every rank and takes its rows,
    then its channels or rows on the model axis);
  * the gradient: `all_reduce_grads_` sums the ranks' gradients of their
    shares over the data group (over every rank for the backbone's
    leaves when it ran on row slabs: each slab's gradient is partial);
  * the model axis's activations: the collectives below are
    autograd.Functions whose backward is their forward's adjoint.
Inside `data_parallel(dp)` the losses, live BN and the model axis reduce
over the ranks; outside it they are the one-process functions.  One process
is `dp=None` everywhere: a DataParallel is always a rank of two or more.

The rank count follows the JAX Solver's rule (solver.py:234-242): the
data axis is the largest divisor of the batch that fits MESH.DATA, or every
visible GPU over m when MESH.DATA <= 0, times m.  Unlike JAX, the ranks
may outnumber the GPUs: they then share them (four ranks on one card).  The
backend is decided before the group starts and printed: `nccl` when every
rank has a GPU of its own, `gloo` when ranks share a GPU (NCCL refuses two
ranks on one device) or run on the CPU.  Every collective is an all-reduce
(or a broadcast): gloo reduces CUDA tensors, but gathers and sends only CPU
ones, so a gather is an all-reduce over a zero-filled buffer in which each
rank writes its own slot.  Nothing falls back: a rank without its GPU, a
failed init_process_group or a failed collective raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import span


def local_batch_rows(process_index: int, process_count: int, batch_size: int) -> slice:
    """Contiguous leading-dim rows owned by this process (JAX multihost.py:25-33):
    rank r holds the r-th block, as JAX's process-major device order lines
    the row blocks up with the mesh's data axis."""
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} must divide over {process_count} processes")
    per = batch_size // process_count
    return slice(process_index * per, (process_index + 1) * per)


def env_ranks() -> tuple[int, int, int, int]:
    """(rank, world, local rank, local world) from torchrun's environment;
    one process (0, 1, 0, 1) where it is not set."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return rank, world, local_rank, local_world


def init_method_from_env() -> str:
    return os.environ.get("DP_INIT_METHOD", "env://")


@dataclass(frozen=True)
class DataParallel:
    """One rank of a run of two or more ranks: its rank, the number of
    ranks (`world` = data x model), its device and the backend of the
    default group its device tensors reduce over.  `host_group` carries the
    host's small agreements (the stop flag, the batch shapes, the snapshot
    to resume from): a gloo group beside an nccl one, else None (the
    default group).  `model` is the model axis's size m, `spatial` whether
    the backbone's rows split over it; `data_group` and `model_group` are
    this rank's groups along the two axes (None where the axis is the whole
    world: the default group)."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    host_group: Any = None
    model: int = 1
    spatial: bool = False
    data_group: Any = None
    model_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_world(self) -> int:
        return self.world // self.model

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of `batch_size` frames: its
        data index's."""
        return local_batch_rows(self.data_rank, self.data_world, batch_size)

    def group(self, axis: str) -> Any:
        """The process group of `axis`: "data", "model" or "all"."""
        return {"data": self.data_group, "model": self.model_group, "all": None}[axis]

    def size(self, axis: str) -> int:
        return {"data": self.data_world, "model": self.model, "all": self.world}[axis]

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def mesh_shape(cfg: Config, batch_size: int, n_devices: int) -> tuple[int, int]:
    """(n, m): the data axis, the largest divisor of `batch_size` not above
    MESH.DATA, or above the `n_devices` visible GPUs over m when MESH.DATA
    <= 0, and the model axis m = MESH.MODEL (JAX solver.py:234-242's rule;
    a MESH.DATA above the GPUs makes ranks share them, where JAX would cap
    it)."""
    m = max(1, cfg.mesh.model)
    want = cfg.mesh.data if cfg.mesh.data > 0 else max(n_devices // m, 1)
    n = max(d for d in range(1, max(min(want, batch_size), 1) + 1) if batch_size % d == 0)
    return n, m


def data_world_size(cfg: Config, batch_size: int, n_devices: int) -> int:
    """The number of ranks of a run: n * m of mesh_shape."""
    n, m = mesh_shape(cfg, batch_size, n_devices)
    return n * m


def backend_for(local_world: int, n_gpus: int, device_type: str) -> tuple[str, str]:
    """(backend, why): nccl when each of this host's `local_world` ranks
    has a GPU of its own, gloo when they share GPUs or run on the CPU."""
    if device_type == "cuda" and local_world <= n_gpus:
        return "nccl", "each rank has a GPU of its own"
    if device_type == "cuda":
        return "gloo", (f"{local_world} ranks share {n_gpus} GPU(s); NCCL refuses two ranks on "
                        "one device, gloo carries the CUDA tensors through the host")
    return "gloo", "CPU ranks"


def init_data_parallel(
    cfg: Config,
    batch_size: int,
    *,
    rank: Optional[int] = None,
    world: Optional[int] = None,
    local_rank: Optional[int] = None,
    local_world: Optional[int] = None,
    init_method: Optional[str] = None,
    device: str = "cuda",
) -> Optional[DataParallel]:
    """Join the data-parallel group of a run (make_mesh's counterpart).

    rank/world/local_rank default to torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; multihost.env_ranks), the
    rendezvous to DP_INIT_METHOD or env:// (MASTER_ADDR, MASTER_PORT).
    The world must be the one data_world_size plans for MESH.DATA, the
    global batch and the visible GPUs (of every host: world / local_world
    hosts), else ValueError.  A rank's device is cuda:(local_rank mod the
    GPUs), or the CPU with device "cpu"; a "cuda" run without a visible
    GPU raises.  One rank joins no group and returns None: the
    one-process run on the caller's device."""
    if rank is None:
        rank, world, local_rank, local_world = env_ranks()
    world = 1 if world is None else world
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device cuda, but no CUDA device is visible")
        n_gpus = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_gpus)
        visible = n_gpus * max(world // max(local_world, 1), 1)
    else:
        n_gpus, dev, visible = 0, torch.device("cpu"), 1
    n, m = mesh_shape(cfg, batch_size, visible)
    if world != n * m:
        raise ValueError(
            f"{world} ranks started, but MESH.DATA {cfg.mesh.data} x MESH.MODEL {m} with a "
            f"global batch of {batch_size} on {visible} device(s) plans {n * m}: set MESH.DATA "
            f"{world // m}")
    if world == 1:
        return None
    backend, why = backend_for(local_world, n_gpus, device_type)
    if rank == 0:
        axes = f" = {n} data x {m} model" + (", the backbone's rows split" if cfg.mesh.spatial
                                             else "") if m > 1 else ""
        print(f"data parallel: {world} ranks{axes}, backend {backend} ({why})", flush=True)
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or init_method_from_env(),
                            rank=rank, world_size=world)
    host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    data_group = model_group = None
    if m > 1:
        # every rank creates every group, in the same order
        for j in range(m):
            g = dist.new_group([d * m + j for d in range(n)])
            if j == rank % m:
                data_group = g
        for d in range(n):
            g = dist.new_group([d * m + j for j in range(m)])
            if d == rank // m:
                model_group = g
    return DataParallel(rank, world, dev, backend, host_group, model=m,
                        spatial=bool(cfg.mesh.spatial) and m > 1, data_group=data_group,
                        model_group=model_group)


def shutdown(dp: Optional[DataParallel]) -> None:
    """Leave the group (nothing for one process, None)."""
    if dp is not None and dist.is_initialized():
        dist.destroy_process_group()


# -- the global functions the step calls inside data_parallel ------------------

# the group of the enclosing data_parallel block, for this thread (the
# loader's threads and everything outside the block see None)
_ACTIVE: contextvars.ContextVar[Optional[DataParallel]] = contextvars.ContextVar(
    "data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(dp: Optional[DataParallel]) -> Iterator[None]:
    """Within the block the losses' means and live BN's statistics are the
    global batch's, over `dp`'s ranks (nothing changes with None)."""
    token = _ACTIVE.set(dp)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[DataParallel]:
    """The rank of the enclosing data_parallel block (None outside it)."""
    return _ACTIVE.get()


def world_size(axis: str = "data") -> int:
    """The ranks along `axis` of the active block (1 outside data_parallel)."""
    dp = _ACTIVE.get()
    return 1 if dp is None else dp.size(axis)


class CollectiveStats:
    """Calls, bytes and milliseconds of the collectives by (axis, phase),
    phase 'forward', 'backward' or 'update' (the optimizer's gradient and
    norm reductions), while `enabled`.  A counted collective synchronizes
    the device before and after it, so its milliseconds are its own (host
    clock) and a step timed with the count on is slower than one without."""

    def __init__(self):
        self.enabled = False
        self.table: Dict[tuple, List[float]] = {}

    def reset(self) -> None:
        self.table = {}

    def add(self, key: tuple, nbytes: int, ms: float) -> None:
        row = self.table.setdefault(key, [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += ms


STATS = CollectiveStats()


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def zeros_like_layout(shape: Sequence[int], x: torch.Tensor,
                      fmt: Optional[torch.memory_format] = None) -> torch.Tensor:
    """Zeros of `shape` in x's dtype, device and memory format (or `fmt`)."""
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt or _memory_format(x)).zero_()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A view of `t` in its own memory order (a channels_last tensor as
    NHWC): what a collective takes."""
    if t.is_contiguous():
        return t
    if _memory_format(t) == torch.channels_last:
        return t.permute(0, 2, 3, 1)
    raise ValueError("a collective needs a dense tensor")


def all_reduce_(t: torch.Tensor, dp: DataParallel, axis: str, phase: str = "update",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce `t` in place over `dp`'s `axis` group ("data", "model",
    "all"); nothing where that group is this rank alone."""
    if dp.size(axis) == 1:
        return t
    dense = _dense(t)
    with span("dp.all_reduce"):
        if not STATS.enabled:
            dist.all_reduce(dense, op=op, group=dp.group(axis))
            return t
        cuda = t.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(dense, op=op, group=dp.group(axis))
        if cuda:
            torch.cuda.synchronize(t.device)
    STATS.add((axis, phase), t.numel() * t.element_size(), (time.perf_counter() - t0) * 1e3)
    return t


class _GlobalSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks; dx = the sum of dy over
    them (each rank's loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, dp, axis):
        ctx.dp, ctx.axis = dp, axis
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), dp, axis, "forward")

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        return all_reduce_(dx, ctx.dp, ctx.axis, "backward"), None, None


def global_sum(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The sum of `t` over the active block's `axis` group, differentiable:
    its gradient is the sum of the ranks' gradients.  `t` itself outside
    data_parallel."""
    dp = _ACTIVE.get()
    return t if dp is None else _GlobalSum.apply(t, dp, axis)


def reduce_sum(t: torch.Tensor, dp: Optional[DataParallel] = None, axis: str = "data"
               ) -> torch.Tensor:
    """The sum of a copy of `t` over the `axis` group of `dp` (or of the
    active block), without gradient; `t` with one process."""
    dp = dp or _ACTIVE.get()
    if dp is None:
        return t
    return all_reduce_(t.detach().clone(), dp, axis)


def reduce_max(t: torch.Tensor, dp: Optional[DataParallel] = None, axis: str = "data"
               ) -> torch.Tensor:
    """reduce_sum's elementwise maximum."""
    dp = dp or _ACTIVE.get()
    if dp is None:
        return t
    return all_reduce_(t.detach().clone(), dp, axis, op=dist.ReduceOp.MAX)


def reduce_losses(losses: Mapping[str, torch.Tensor], dp: Optional[DataParallel]
                  ) -> Dict[str, torch.Tensor]:
    """The global losses from the data ranks' shares (their sum over the
    data group; a model group's ranks hold one share), in one all-reduce;
    the losses as they are with one process."""
    if dp is None:
        return dict(losses)
    keys = list(losses)
    total = reduce_sum(torch.stack([losses[k].detach().float() for k in keys]), dp)
    return dict(zip(keys, total.unbind()))


def all_reduce_grads_(grads: Sequence[torch.Tensor], dp: Optional[DataParallel],
                      axis: str = "data") -> None:
    """Sum `grads` over the `axis` group in place: one flat bucket a dtype
    (the float32 masters' gradients are one), one all-reduce each."""
    if dp is None or not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = all_reduce_(_flatten_dense_tensors(group), dp, axis)
        for g, r in zip(group, _unflatten_dense_tensors(flat, group)):
            g.copy_(r)


def broadcast_parameters_(model: torch.nn.Module, dp: Optional[DataParallel],
                          optimizer: Any = None) -> None:
    """Replicate rank 0's parameters and buffers (the live-BN running
    statistics among them) on every rank, one flat bucket a dtype, whole:
    a model whose tail is sharded is gathered first.  With a model axis
    each rank then keeps its shards (tensor_parallel.shard_model_, the
    optimizer's momentum too)."""
    if dp is None:
        return
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import tensor_parallel as tp

    if tp.is_sharded(model):
        tp.unshard_model_(model, dp, optimizer)
    tensors = [t.data for t in model.parameters()] + [t for t in model.buffers()]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = _flatten_dense_tensors(group)
            dist.broadcast(flat, src=0)
            for t, r in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(r)
    if dp.model > 1:
        tp.shard_model_(model, dp, optimizer)


# -- the model axis's collectives: each backward is its forward's adjoint -------------


def model_axis() -> DataParallel:
    """The active rank, which must have a model axis."""
    dp = _ACTIVE.get()
    if dp is None or dp.model == 1:
        raise RuntimeError("a model-axis collective outside data_parallel of a run with "
                           "MESH.MODEL > 1 (a sharded model runs inside mesh.data_parallel)")
    return dp


class _CopyToModel(torch.autograd.Function):
    """y = x, a tensor every rank of the model group holds whole, entering
    layers each rank computes a part of: dx = the sum of the ranks' dy."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=_memory_format(dy))
        return all_reduce_(dx, ctx.dp, "model", "backward"), None


class _ReduceFromModel(torch.autograd.Function):
    """y = the sum of the model group's partial x; dx = dy (every rank
    holds y whole)."""

    @staticmethod
    def forward(ctx, x, dp):
        return all_reduce_(x.clone(memory_format=_memory_format(x)), dp, "model", "forward")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _slots(x: torch.Tensor, dim: int, lo: int, total: int, dp: DataParallel,
           phase: str) -> torch.Tensor:
    """x written at [lo, lo + x.shape[dim]) of a zero tensor `total` wide
    along `dim`, summed over the model group: the ranks' parts side by side."""
    shape = list(x.shape)
    shape[dim] = total
    y = zeros_like_layout(shape, x)
    y.narrow(dim, lo, x.shape[dim]).copy_(x)
    return all_reduce_(y, dp, "model", phase)


class _GatherModel(torch.autograd.Function):
    """Each rank's part (x, at [lo, lo + n) of `total` along `dim`) to the
    whole on every rank; dx = the rank's part of dy, which every rank
    holds whole."""

    @staticmethod
    def forward(ctx, x, dp, dim, lo, total):
        ctx.args = (dim, lo, x.shape[dim], _memory_format(x))
        return _slots(x, dim, lo, total, dp, "forward")

    @staticmethod
    def backward(ctx, dy):
        dim, lo, n, fmt = ctx.args
        return dy.narrow(dim, lo, n).contiguous(memory_format=fmt), None, None, None, None


class _SplitModel(torch.autograd.Function):
    """The rank's part [lo, lo + n) along `dim` of a tensor every rank
    holds whole; dx = the ranks' parts of dy side by side."""

    @staticmethod
    def forward(ctx, x, dp, dim, lo, n):
        ctx.dp, ctx.args = dp, (dim, lo, x.shape[dim])
        return x.narrow(dim, lo, n).contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, dy):
        dim, lo, total = ctx.args
        return _slots(dy, dim, lo, total, ctx.dp, "backward"), None, None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, model_axis())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, model_axis())


def gather_model(x: torch.Tensor, dim: int, lo: int, total: int) -> torch.Tensor:
    return _GatherModel.apply(x, model_axis(), dim, lo, total)


def split_model(x: torch.Tensor, dim: int, lo: int, n: int) -> torch.Tensor:
    return _SplitModel.apply(x, model_axis(), dim, lo, n)


# -- the host's agreements --------------------------------------------------------


def any_rank(flag: bool, dp: Optional[DataParallel]) -> bool:
    """Whether `flag` is set on any rank (the Solver's stop flag): every
    rank gets the same answer for the same call."""
    if dp is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.host_group)
    return bool(t.item())


def check_same_shape(shape: Sequence[int], dp: Optional[DataParallel], what: str) -> None:
    """Raise unless every rank holds `shape`: live BN's statistics and the
    draws' row blocks assume shards of one shape (a rank's loader pads an
    image batch to the largest frame over the ranks: max_over_ranks)."""
    if dp is None:
        return
    v = [int(s) for s in shape]
    t = torch.tensor(v + [-s for s in v], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.host_group)
    if t[: len(v)].tolist() != v or (-t[len(v):]).tolist() != v:
        raise RuntimeError(f"rank {dp.rank}: {what} {tuple(v)} differs between the ranks "
                           f"(largest {tuple(t[: len(v)].tolist())})")


def max_over_ranks(values: Sequence[int], dp: Optional[DataParallel]) -> List[int]:
    """Host integers, each the largest over the ranks (the values with one
    process)."""
    if dp is None:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.host_group)
    return [int(v) for v in t.tolist()]


def host_sum(values: Sequence[float], dp: Optional[DataParallel]) -> List[float]:
    """Host numbers summed over the ranks (float64)."""
    if dp is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, group=dp.host_group)
    return t.tolist()


def broadcast_object(obj: Any, dp: Optional[DataParallel]) -> Any:
    """Rank 0's `obj` (picklable) on every rank."""
    if dp is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=dp.host_group)
    return box[0]


def barrier(dp: Optional[DataParallel]) -> None:
    if dp is not None:
        dist.barrier(group=dp.host_group)


def shard_batch(batch: Mapping[str, Any], dp: DataParallel) -> Dict[str, Any]:
    """This rank's rows of a host batch, on its device (JAX shard_batch,
    mesh.py:83-114): every array's leading rows local_batch_rows; rank-0
    leaves (the loader's scale_idx) replicated; '_' keys dropped, as
    training.solver.batch_to_device drops them."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import batch_to_device

    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        if not getattr(v, "ndim", 0):
            out[k] = v
        else:
            out[k] = v[dp.rows(v.shape[0])]
            if isinstance(out[k], np.ndarray):
                out[k] = np.ascontiguousarray(out[k])
    return batch_to_device(out, dp.device)

