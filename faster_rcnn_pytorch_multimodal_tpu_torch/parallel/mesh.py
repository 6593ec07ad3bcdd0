"""Data-parallel process groups: the port of the JAX package's
parallel/mesh.py data axis (make_mesh, shard_batch, the replicated state).

JAX's step is one SPMD program over the global batch, so four things are
global there that a naive per-process port would make local:
  * each live batch-norm mean and variance (models.resnet.LiveBatchNorm
    takes them over the global batch through `global_sum`);
  * each weighted loss's denominator (ops.losses: `sum(nll * w) /
    max(sum(w), 1)` with the global sum of w) and each plain mean (a
    rank's loss is its share of the global loss: the global loss is the
    sum over the ranks);
  * every random draw (the training step draws the global batch's keys
    and dropout masks from one generator on every rank and takes its rows);
  * the gradient: `all_reduce_grads_` sums the ranks' gradients of their
    shares, which is the global loss's gradient.
Inside `data_parallel(dp)` the losses and live BN reduce over the ranks;
outside it they are the one-process functions.  One process is `dp=None`
everywhere: a DataParallel is always a rank of two or more.

The world size follows the JAX Solver's rule (solver.py:234-242): the
largest divisor of the batch that fits MESH.DATA, or every visible GPU when
MESH.DATA <= 0.  Unlike JAX, MESH.DATA may exceed the GPUs: the ranks then
share them (two ranks on one card).  The backend is decided before the
group starts and printed: `nccl` when every rank has a GPU of its own,
`gloo` when ranks share a GPU (NCCL refuses two ranks on one device) or
run on the CPU.  Nothing falls back: a rank without its GPU, a failed
init_process_group or a failed collective raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config

NOT_PORTED = ("MESH.MODEL > 1 and MESH.SPATIAL (tensor and spatial parallelism) are not "
              "ported: ROADMAP A4")


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
    """One rank of a data-parallel run of two or more ranks: its rank, the
    world size, its device and the backend of the default group its device
    tensors reduce over.  `host_group` carries the host's small agreements
    (the stop flag, the batch shapes, the snapshot to resume from): a gloo
    group beside an nccl one, else None (the default group)."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    host_group: Any = None

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of `batch_size` frames."""
        return local_batch_rows(self.rank, self.world, batch_size)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def data_world_size(cfg: Config, batch_size: int, n_devices: int) -> int:
    """The number of ranks of a run: the largest divisor of `batch_size`
    not above MESH.DATA, or above the `n_devices` visible GPUs when
    MESH.DATA <= 0 (JAX solver.py:234-242's rule; a MESH.DATA above the
    GPUs makes ranks share them, where JAX would cap it)."""
    if cfg.mesh.model > 1 or cfg.mesh.spatial:
        raise NotImplementedError(NOT_PORTED)
    want = cfg.mesh.data if cfg.mesh.data > 0 else n_devices
    return max(d for d in range(1, max(min(want, batch_size), 1) + 1) if batch_size % d == 0)


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
    planned = data_world_size(cfg, batch_size, visible)
    if world != planned:
        raise ValueError(
            f"{world} ranks started, but MESH.DATA {cfg.mesh.data} with a global batch of "
            f"{batch_size} on {visible} device(s) plans {planned}: set MESH.DATA {world}")
    if world == 1:
        return None
    backend, why = backend_for(local_world, n_gpus, device_type)
    if rank == 0:
        print(f"data parallel: {world} ranks, backend {backend} ({why})", flush=True)
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or init_method_from_env(),
                            rank=rank, world_size=world)
    host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    return DataParallel(rank, world, dev, backend, host_group)


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


def world_size() -> int:
    """The ranks the active block reduces over (1 outside data_parallel)."""
    dp = _ACTIVE.get()
    return 1 if dp is None else dp.world


class _GlobalSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks; dx = the sum of dy over
    them (each rank's loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx)
        return dx


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the active block's ranks, differentiable: its
    gradient is the sum of the ranks' gradients.  `t` itself outside
    data_parallel."""
    dp = _ACTIVE.get()
    return t if _ACTIVE.get() is None else _GlobalSum.apply(t)


def reduce_sum(t: torch.Tensor, dp: Optional[DataParallel] = None) -> torch.Tensor:
    """The sum of a copy of `t` over the ranks of `dp` (or of the active
    block), without gradient; `t` with one process."""
    if (dp or _ACTIVE.get()) is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def reduce_max(t: torch.Tensor, dp: Optional[DataParallel] = None) -> torch.Tensor:
    """reduce_sum's elementwise maximum."""
    if (dp or _ACTIVE.get()) is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def reduce_losses(losses: Mapping[str, torch.Tensor], dp: Optional[DataParallel]
                  ) -> Dict[str, torch.Tensor]:
    """The global losses from the ranks' shares (their sum), in one
    all-reduce; the losses as they are with one process."""
    if dp is None:
        return dict(losses)
    keys = list(losses)
    total = reduce_sum(torch.stack([losses[k].detach().float() for k in keys]), dp)
    return dict(zip(keys, total.unbind()))


def all_reduce_grads_(grads: Sequence[torch.Tensor], dp: Optional[DataParallel]) -> None:
    """Sum `grads` over the ranks in place: one flat bucket a dtype (the
    float32 masters' gradients are one), one all-reduce each."""
    if dp is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat)
        for g, r in zip(group, _unflatten_dense_tensors(flat, group)):
            g.copy_(r)


def broadcast_parameters_(model: torch.nn.Module, dp: Optional[DataParallel]) -> None:
    """Replicate rank 0's parameters and buffers (the live-BN running
    statistics among them) on every rank, one flat bucket a dtype."""
    if dp is None:
        return
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

