"""Multi-process (multi-host) data-parallel pieces: the port of the JAX
package's parallel/multihost.py.

JAX starts one process a host with `jax.distributed.initialize` and
stitches the processes' local rows into global arrays.  Here every rank is
a process; the environment contract is torchrun's:
  RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, and MASTER_ADDR /
  MASTER_PORT for the default env:// rendezvous, or DP_INIT_METHOD naming
  another one (e.g. file:///path/to/a/new/file, tcp://host:port).
A rank assembles only its rows of the global batch, which every rank's
sampler draws alike (data.loader.BatchLoader(dp=...), its rows local_batch_rows),
so no global array is ever stitched: JAX's `global_batch` has no
counterpart.

`spawn_ranks` starts a run's ranks on one host (the CLI's and
chip_smoke.py's launcher: spawned processes, a file:// rendezvous in a
fresh temporary directory); a rank that fails stops the others.

`worker_main` is the CPU dry run of JAX's :53-175: each process computes
the one-process step on the full batch from the shared deterministic
sampler and holds the N-process step's loss and parameters to it:

    RANK=0 WORLD_SIZE=2 DP_INIT_METHOD=file:///tmp/rdv python -m \
        faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost &
    RANK=1 WORLD_SIZE=2 DP_INIT_METHOD=file:///tmp/rdv python -m \
        faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost
or `torchrun --nproc_per_node 2 -m faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost`.
The ranks run on the GPUs (`--device cuda`, the default); `--device cpu`
puts them on the CPU.  `--set MESH.MODEL 2 MESH.SPATIAL True` (config
overrides) makes the WORLD_SIZE ranks a (WORLD_SIZE / 2) x 2 mesh whose
model axis shards the RoI tail and splits the backbone's rows.
"""

from __future__ import annotations

import os
import queue
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

# the env contract's readers and the row split live in mesh.py, which the
# package imports; this module is also run as __main__
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.mesh import (  # noqa: F401
    env_ranks,
    init_method_from_env,
    local_batch_rows,
)


def _rank_main(target, rank: int, world: int, init_method: str, results, args) -> None:
    try:
        value = target(rank, world, init_method, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def spawn_ranks(target: Callable, world: int, *args, timeout: Optional[float] = None
                ) -> List[Any]:
    """Run target(rank, world, init_method, *args) in `world` spawned
    processes (rank 0..world-1; target must be importable: a module-level
    function) and return each rank's return value, by rank: small picklable
    values (a rank's tensors are better saved to a file: a queue shares
    their memory with a process that is about to exit).
    init_method is a file:// rendezvous in a fresh temporary directory,
    removed after.  A rank that raises or dies stops the others (they may
    wait in a collective) and raises RuntimeError with its traceback: no
    rank's failure passes silently.  Called on the main thread, it forwards
    SIGINT and SIGTERM to every rank, whose Solver snapshots and stops.
    With `timeout` (seconds) ranks still running then are stopped and
    RuntimeError raised (a collective that never completes).  Build the
    CUDA kernels before (ops._build.build()): else every rank runs nvcc."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="frcnn_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(target, r, world, init_method, results, args))
             for r in range(world)]

    def forward(sig, _frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, sig)

    previous = {}
    try:
        for sig in (signal.SIGINT, signal.SIGTERM):
            previous[sig] = signal.signal(sig, forward)
    except ValueError:  # not the main thread
        previous = {}
    values, failed = {}, []

    def collect(item) -> None:
        rank, ok, value = item
        if ok:
            values[rank] = value
        else:
            failed.append((rank, value))

    try:
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in procs:
            p.start()
        running = list(procs)
        while running and not failed:
            if deadline is not None and time.monotonic() > deadline:
                failed.append((procs.index(running[0]), f"still running after {timeout} s"))
                break
            wait([p.sentinel for p in running], timeout=0.2)
            ended = [p for p in running if p.exitcode is not None]
            died = [p for p in ended if p.exitcode != 0]
            while True:  # a rank's result must be read before it can exit
                try:
                    collect(results.get(timeout=2.0 if died else 0.0))
                except queue.Empty:
                    break
            running = [p for p in running if p not in ended]
            if died and not failed:
                failed.append((procs.index(died[0]), f"exit code {died[0].exitcode}"))
        while len(values) < world and not failed:
            collect(results.get(timeout=10))
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10)
                if p.exitcode is None:  # a rank whose Solver caught the SIGTERM, or
                    p.kill()            # one blocked in a collective
                    p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        rank, why = failed[0]
        raise RuntimeError(f"rank {rank} of {world} failed:\n{why}")
    return [values[r] for r in range(world)]


def worker_main(argv=None) -> None:
    """One rank of the dry run (the JAX test's res18 config at 64x96, float32
    compute, a global batch of one frame a data rank): the N-rank step
    against the one-process step on the same global batch, computed in
    every rank; the loss within 1e-3 relative and every parameter within
    1e-3, JAX worker_main's bars.  `--device cpu` puts the ranks on the CPU
    (cuda by default: rank 0 builds the kernels, the others wait; TF32 off,
    as the bars are float32's); `--set KEY VALUE ...` overrides the config
    (MESH.MODEL, MESH.SPATIAL: the model axis, its parameters gathered
    whole before the comparison)."""
    import argparse
    import copy

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh, tensor_parallel
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        batch_to_device,
        create_train_state,
        draw_train_keys,
        make_train_step,
        step_generator,
    )

    parser = argparse.ArgumentParser(description=worker_main.__doc__)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--set", dest="overrides", nargs="*", default=[],
                        help="config overrides, e.g. MESH.MODEL 2 MESH.SPATIAL True")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    rank, world, local_rank, local_world = env_ranks()
    if world < 2:
        raise SystemExit("multihost dry run: start two or more processes (WORLD_SIZE)")
    cfg = cfg_from_list(default_config(), (
        "NET_TYPE", "image", "NET_VARIANT", "res18", "COMPUTE_DTYPE", "float32",
        "PIXEL_STDDEVS", "[60.,60.,60.]", "TRAIN.RPN_POST_NMS_TOP_N", "32",
        "TRAIN.ROI_BATCH_SIZE", "16", "STATIC.NMS_PRE_TRAIN", "128", "STATIC.MAX_GT", "8",
        "ANCHOR_SCALES", "[4,8]", "ANCHOR_RATIOS", "[0.5,1,2]", *args.overrides,
    ))
    batch_size = world // max(1, cfg.mesh.model)
    cfg = cfg_from_list(cfg, ("MESH.DATA", str(batch_size)))
    dp = mesh.init_data_parallel(cfg, batch_size, rank=rank, world=world, local_rank=local_rank,
                                 local_world=local_world, device=args.device)
    try:
        if dp.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if dp.is_main:
                _build.build()
            mesh.barrier(dp)
        ds = SyntheticDataset(cfg, num_frames=batch_size * 2, num_classes=2, image_hw=(64, 96))
        model, _ = create_train_state(cfg, 2, dp.device, seed=0)
        ref = copy.deepcopy(model)
        mesh.broadcast_parameters_(model, dp)
        local = batch_to_device(BatchLoader(ds, cfg, batch_size, device=dp.device, seed=0,
                                            dp=dp).next(), dp.device)
        step = make_train_step(model, DetectorSGD(model, cfg, dp=dp), dp)
        losses, _ = step(local, draw_train_keys(model, local, step_generator(0, 0, dp.device), dp))

        full = batch_to_device(BatchLoader(ds, cfg, batch_size, device=dp.device, seed=0).next(),
                               dp.device)
        ref_step = make_train_step(ref, DetectorSGD(ref, cfg))
        ref_losses, _ = ref_step(full, draw_train_keys(ref, full, step_generator(0, 0, dp.device)))

        if tensor_parallel.is_sharded(model):
            tensor_parallel.unshard_model_(model, dp)
        total, total_1 = float(losses["total_loss"]), float(ref_losses["total_loss"])
        assert total == total and abs(total) != float("inf"), f"rank {rank}: loss {total}"
        assert abs(total - total_1) < 1e-3 * max(1.0, abs(total_1)), (
            f"rank {rank}: loss diverges {total} vs 1-process {total_1}")
        ref_params = dict(ref.named_parameters())
        max_delta = max(float((p.detach() - ref_params[k].detach()).abs().max())
                        for k, p in model.named_parameters())
        assert max_delta < 1e-3, f"rank {rank}: params diverge, max |dp - 1-process| {max_delta}"
        if rank == 0:
            axes = f" = {dp.data_world} data x {dp.model} model" if dp.model > 1 else ""
            print(f"multihost dryrun ok: {world} ranks{axes} ({dp.backend}), "
                  f"total_loss={total:.4f}, "
                  f"max param delta vs 1-process={max_delta:.3e}", flush=True)
    finally:
        mesh.shutdown(dp)


if __name__ == "__main__":
    worker_main(sys.argv[1:])
