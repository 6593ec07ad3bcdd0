"""Host batch loader: epoch iteration, padding, and the device-side raster.

A copy of what the port's paths use of the JAX package's
faster_rcnn_pytorch_multimodal_tpu/data/loader.py: `_assemble_batch`
(:28-140) and the sampler `_new_perm`,
`_next_indices`, `_sample_task`, `peek` and `next` (:251-306), on the same
np.random.RandomState stream, so equal seeds give equal batches.

Outputs are padded to static shapes:
  image:  data (B, H, W, 3) uint8 numpy, padded with the mean pixel;
  lidar:  data (B, Y, X, slices + 3) float32 torch tensor on `device`: the
          host ships the raw points (B, P, 5) and point_valid (B, P) and
          `voxelize_bev` rasterizes them there, so the raster never visits
          the host (`_finalize`, as the JAX loader's :475-492);
  gt_boxes (B, G, 5|8), gt_mask (B, G), window (B, 4), gt_boxes_dc, dc_mask.

The raster's grid uses TRAIN.SCALES[0] even at test time, as the JAX loader
does (:453); serving configs set TRAIN.SCALES and TEST.SCALES alike.

The sampler's resume state (`state_dict`, `load_state_dict`: cur, perm,
epoch and the full MT19937 state, JAX :200-249) and the background prefetch
thread (`start`, `kill`, JAX :310-354, :412-441) are JAX's: each prefetched
task keeps the sampler state it was drawn from, so `state_dict` names the
next batch `next()` has not handed out yet, however far the thread has run
ahead.  On a CUDA device the thread makes its batches' device work (the
points' copy, `voxelize_bev`, the caller's `transfer`) on a stream of its
own from pinned host memory; `next()` makes the consumer's stream wait for
that batch's event and marks its tensors as used there, so the caching
allocator cannot hand their memory out while the step still reads them.

With `workers > 0`, `start` assembles batches in worker processes, as the
JAX loader does (:143-152, :355-410): spawned children run
`_assemble_batch` (numpy; they never touch CUDA) on tasks a feeder thread
samples with the same bookkeeping as the prefetch thread, and a collector
thread puts their batches back in sampler order and finalizes each as the
prefetch thread does (the points' pinned copy and `voxelize_bev` on the
loader's stream, its event), so the stream is the serial loader's whatever
the number of workers.  The workers start once per `start` and stop in
`kill`.

With `rows` (a slice of the global batch: parallel.local_batch_rows) the
loader is one data-parallel rank's, as JAX's multi-host loader is
(`_assemble_batch(..., rows)`, :45-52): the sampler draws the global task
(batch_size is the global batch) on every rank alike, and only the rank's
rows are assembled, in the prefetch thread and in the worker processes
too.  So `state_dict` is global and the same on every rank, and a resume
is exact whatever the number of ranks.  An image batch's rows are padded
to their own largest frame's bucket there; with `dp` (the rank) next() then
pads them, on the consumer's thread, to the largest bucket over the ranks:
the global task's, which JAX pads the global batch to before it slices a
process's rows (parallel/multihost.py:124-140).  So frames of mixed sizes
give every rank one shape, without a rank reading another's frames.

DEBUG.DRAW_MINIBATCH draws each assembled frame with its GT boxes into
debug/minibatch_draws/ (JAX :494-519), where the batch is finalized.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.mesh import DataParallel
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer


def _assemble_batch(dataset, cfg: Config, augment: bool, task,
                    rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """Numpy batch assembly from a sampled task (indices, seeds, scale_idx):
    each frame gets its own RandomState seeded from the task.  With `rows`
    only those rows of the global task are assembled (a data-parallel
    rank's)."""
    indices, seeds, scale_idx = task
    if rows is not None:
        indices, seeds = indices[rows], seeds[rows]
    scale = (
        float(cfg.train.scales[scale_idx])
        if augment and cfg.net_type != "lidar"
        else None
    )
    frames = [
        dataset.frame(
            int(i), augment=augment, rng=np.random.RandomState(s), scale=scale
        )
        for i, s in zip(indices, seeds)
    ]
    g = cfg.static.max_gt
    n_elem = 8 if cfg.net_type == "lidar" else 5
    b = len(frames)

    gt = np.zeros((b, g, n_elem), np.float32)
    gt_mask = np.zeros((b, g), bool)
    window = np.zeros((b, 4), np.float32)
    for i, f in enumerate(frames):
        boxes = f["gt_boxes"][:g]
        gt[i, : len(boxes)] = boxes
        gt_mask[i, : len(boxes)] = True
        window[i] = f["window"]

    batch: Dict[str, np.ndarray] = {
        "gt_boxes": gt,
        "gt_mask": gt_mask,
        "window": window,
        "_indices": np.asarray(indices),
    }
    if augment and cfg.net_type != "lidar" and len(cfg.train.scales) > 1:
        batch["scale_idx"] = np.int32(scale_idx)

    # don't-care regions (always 4 columns) feed TRAIN.IGNORE_DC
    d = cfg.static.max_gt_dc
    dc = np.zeros((b, d, 4), np.float32)
    dc_mask = np.zeros((b, d), bool)
    for i, f in enumerate(frames):
        fdc = f.get("gt_boxes_dc")
        if fdc is not None and len(fdc):
            fdc = fdc[:d]
            dc[i, : len(fdc)] = fdc
            dc_mask[i, : len(fdc)] = True
    batch["gt_boxes_dc"] = dc
    batch["dc_mask"] = dc_mask

    if cfg.net_type == "lidar":
        p = cfg.static.max_points
        pts = np.zeros((b, p, 5), np.float32)
        pvalid = np.zeros((b, p), bool)
        for i, f in enumerate(frames):
            fp = f["points"][:p]
            pts[i, : len(fp)] = fp
            pvalid[i, : len(fp)] = True
        batch["points"] = pts
        batch["point_valid"] = pvalid
    else:
        # pad to the batch max rounded up to a 64-pixel bucket
        def _bucket(v: int) -> int:
            return ((v + 63) // 64) * 64

        h = _bucket(max(f["data"].shape[0] for f in frames))
        w = _bucket(max(f["data"].shape[1] for f in frames))
        dtype = frames[0]["data"].dtype
        nch = frames[0]["data"].shape[2]
        data = np.empty((b, h, w, nch), dtype)
        data[...] = pad_value(cfg, dtype, nch)
        for i, f in enumerate(frames):
            fh, fw = f["data"].shape[:2]
            data[i, :fh, :fw] = f["data"]
        batch["data"] = data
    return batch


def pad_value(cfg: Config, dtype, nch: int) -> np.ndarray:
    """What an image batch is padded with: the mean pixel for uint8 frames
    (it normalizes to zero), else zero."""
    if np.issubdtype(np.dtype(dtype), np.integer) and nch == len(cfg.pixel_means):
        fill = np.asarray(cfg.pixel_means, np.float32)
        return np.clip(np.round(fill), 0, 255).astype(dtype)
    return np.zeros((nch,), dtype)


def pad_frames(data, h: int, w: int, cfg: Config):
    """A (B, H, W, C) image batch (numpy or a tensor on any device) padded at
    the bottom and right to (B, h, w, C) with pad_value."""
    b, fh, fw, nch = data.shape
    if isinstance(data, torch.Tensor):
        fill = torch.from_numpy(pad_value(cfg, np.dtype(str(data.dtype).split(".")[-1]), nch))
        out = fill.to(data.device).expand(b, h, w, nch).clone()
    else:
        out = np.empty((b, h, w, nch), data.dtype)
        out[...] = pad_value(cfg, data.dtype, nch)
    out[:, :fh, :fw] = data
    return out


def _worker_loop(dataset, cfg: Config, augment: bool, rows, task_q, result_q) -> None:
    """A worker process: tasks in, assembled numpy batches out (JAX
    :143-152).  An exception goes back in the batch's place."""
    while True:
        try:
            seq, task = task_q.get()
        except (EOFError, OSError):
            return
        try:
            out = _assemble_batch(dataset, cfg, augment, task, rows)
        except BaseException as e:  # handed to the consumer by next()
            out = _Failure(e)
        result_q.put((seq, out))


class _Failure:
    """An exception raised in the prefetch thread or a worker, handed to
    next()."""

    def __init__(self, error: BaseException):
        self.error = error


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: through pinned memory, without blocking the
    host, on a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class BatchLoader:
    """Batches of a dataset in sampler order; lidar rasters on `device`.

    device: where lidar batches are rasterized (required; image batches
    stay numpy on the host unless a `transfer` moves them).
    `last_raster_ms` holds the device time of the last batch's voxelize_bev
    call (CUDA events on the stream that ran it), `last_raster_thread` the
    name of the thread that launched it.  prefetch: the depth of the
    background queue (`start`).  workers: the number of worker processes
    `start` assembles batches in (0: the prefetch thread assembles them).
    rows: a data-parallel rank's rows of each global batch of batch_size
    frames (None: every row).  dp: the rank (a parallel.DataParallel) whose
    rows these are; `rows` defaults to its rows, and next() and peek() pad
    an image batch to the global task's bucket (see the module docstring)."""

    def __init__(
        self,
        dataset,
        cfg: Config,
        batch_size: int,
        *,
        device: torch.device | str,
        augment: bool = True,
        shuffle: bool = True,
        seed: int = 3,
        prefetch: int = 4,
        rasterize: bool = True,
        workers: int = 0,
        rows: Optional[slice] = None,
        dp: Optional[DataParallel] = None,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.dp = dp
        self.rows = dp.rows(batch_size) if dp is not None and rows is None else rows
        self.device = torch.device(device)
        self.augment = augment
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._perm = self._new_perm()
        self._cur = 0
        self._epoch = 0
        self._peeked: Optional[Dict[str, np.ndarray]] = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prefetch = prefetch
        self._transfer = None
        self._stream = None
        # resume bookkeeping: the sampler state each in-flight prefetched
        # batch was drawn from (see state_dict)
        self._state_lock = threading.Lock()
        self._inflight: deque = deque()
        self._workers = workers
        self._procs: list = []
        self._feeder: Optional[threading.Thread] = None
        self._grid = None
        if cfg.net_type == "lidar" and rasterize:
            self._grid = raster_kwargs(cfg, float(cfg.train.scales[0]))
        self._timer = DeviceTimer(self.device)
        self.last_raster_ms: Optional[float] = None
        self.last_raster_thread: Optional[str] = None

    # -- sampler state (resume) -------------------------------------------

    def _capture_state(self) -> Dict[str, np.ndarray]:
        # the full MT19937 state, so that a resumed run draws the same
        # shuffle and augmentation stream as an uninterrupted one
        kind, keys, pos, has_gauss, cached = self._rng.get_state()
        assert kind == "MT19937"
        return {
            "cur": np.asarray(self._cur),
            "perm": np.asarray(self._perm),
            "epoch": np.asarray(self._epoch),
            "rng": np.asarray(keys),
            "rng_pos": np.asarray(pos),
            "rng_has_gauss": np.asarray(has_gauss),
            "rng_cached": np.asarray(cached),
        }

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Sampler state of the next unconsumed batch.  With prefetch
        running the live sampler has drawn ahead of what next() handed out;
        each in-flight task remembers the state it was drawn from, and the
        front of that queue is where a resume must restart."""
        with self._state_lock:
            if self._inflight:
                return dict(self._inflight[0])
            return self._capture_state()

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        with self._state_lock:
            self._inflight.clear()
            self._cur = int(state["cur"])
            self._perm = np.asarray(state["perm"])
            self._epoch = int(state["epoch"])
            if "rng" in state:
                # pos 624 (an exhausted block) for a state without it
                self._rng.set_state((
                    "MT19937",
                    np.asarray(state["rng"], np.uint32),
                    int(state.get("rng_pos", 624)),
                    int(state.get("rng_has_gauss", 0)),
                    float(state.get("rng_cached", 0.0)),
                ))

    # -- iteration -------------------------------------------------------

    def _new_perm(self) -> np.ndarray:
        n = len(self.dataset)
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    def _next_indices(self) -> np.ndarray:
        if self.cfg.debug.freeze_db:
            # pin the sampler to one frame (DEBUG.FREEZE_DB)
            idx = self.cfg.debug.freeze_db_inds % len(self.dataset)
            return np.full((self.batch_size,), idx, np.int64)
        out = []
        for _ in range(self.batch_size):
            if self._cur >= len(self._perm):
                self._perm = self._new_perm()
                self._cur = 0
                self._epoch += 1
            out.append(self._perm[self._cur])
            self._cur += 1
        return np.asarray(out)

    def _sample_task(self, track: bool = False):
        """One batch's (indices, seeds, scale_idx) from the sampler rng;
        track=True (the prefetch thread) records the state it was drawn
        from for state_dict."""
        with self._state_lock:
            if track:
                self._inflight.append(self._capture_state())
            indices = self._next_indices()
            scales = self.cfg.train.scales
            if self.augment and self.cfg.net_type != "lidar" and len(scales) > 1:
                scale_idx = int(self._rng.randint(len(scales)))
            else:
                scale_idx = 0
            seeds = [int(self._rng.randint(1 << 31)) for _ in indices]
        return np.asarray(indices), seeds, scale_idx

    def peek(self) -> Dict[str, object]:
        if self._peeked is None:
            self._peeked = self._pad_to_ranks(self._build_batch(self._sample_task()))
        return self._peeked

    def next(self) -> Dict[str, object]:
        if self._peeked is not None:
            b, self._peeked = self._peeked, None
            return b
        if self._thread is None:
            return self._pad_to_ranks(self._build_batch(self._sample_task()))
        return self._pad_to_ranks(self._next_prefetched())

    def _pad_to_ranks(self, b: Dict[str, object]) -> Dict[str, object]:
        """With dp: an image batch padded to the largest (height, width)
        over the ranks, which is the bucket of the global task's largest
        frame, as JAX pads the global batch before it slices a process's
        rows.  A collective over dp.host_group, so on the consumer's thread
        and in the same order on every rank; no rank reads another's
        frames."""
        if self.dp is None or self.cfg.net_type == "lidar" or "data" not in b:
            return b
        data = b["data"]
        h, w = (int(v) for v in data.shape[1:3])
        gh, gw = mesh.max_over_ranks((h, w), self.dp)
        if (gh, gw) != (h, w):
            b["data"] = pad_frames(data, gh, gw, self.cfg)
        return b

    def _next_prefetched(self) -> Dict[str, object]:
        b = self._q.get()
        if isinstance(b, _Failure):
            raise RuntimeError("BatchLoader: the prefetch thread or a worker failed") from b.error
        with self._state_lock:
            if self._inflight:
                self._inflight.popleft()
        ready = b.pop("_ready", None)
        if ready is not None:
            # the batch's device work ran on the loader's stream: the
            # consumer's stream waits for it, and its tensors count as used
            # there until the consumer's work on them is done
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for v in b.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(consumer)
        return b

    # -- background prefetch ----------------------------------------------

    def start(self, transfer=None) -> None:
        """Begin the background prefetch: a daemon thread samples tasks,
        assembles batches, makes the lidar raster and applies `transfer`
        (host batch -> device batch, e.g. training.solver.batch_to_device)
        while the consumer's step runs, into a queue of `prefetch` batches.
        With workers > 0 the assembly runs in worker processes
        (`_start_workers`)."""
        if self._thread is not None:
            if transfer is not None and transfer is not self._transfer:
                raise RuntimeError(
                    "BatchLoader: already started with a different transfer; kill() it first")
            return
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._transfer = transfer
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)

        def put(item) -> None:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.25)
                    return
                except queue.Full:
                    continue

        if self._workers > 0:
            self._start_workers(put)
            return

        def run() -> None:
            try:
                while not self._stop.is_set():
                    put(self._build_batch(self._sample_task(track=True), self._stream))
            except BaseException as e:  # handed to the consumer by next()
                put(_Failure(e))

        self._thread = threading.Thread(target=run, name="BatchLoader-prefetch", daemon=True)
        self._thread.start()

    def _start_workers(self, put) -> None:
        """Worker processes (JAX :355-410): a spawn context (the parent may
        hold a CUDA context, which a forked child must not inherit); the
        feeder thread samples tasks with the prefetch thread's bookkeeping,
        the workers assemble them, and the collector thread reorders their
        batches by sequence number and finalizes each on the loader's
        stream, as the prefetch thread does."""
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue(maxsize=self._prefetch + self._workers)
        self._result_q = ctx.Queue(maxsize=self._prefetch + self._workers)
        self._procs = [
            ctx.Process(target=_worker_loop, name=f"BatchLoader-worker-{i}",
                        args=(self.dataset, self.cfg, self.augment, self.rows,
                              self._task_q, self._result_q), daemon=True)
            for i in range(self._workers)
        ]
        for p in self._procs:
            p.start()

        def feed() -> None:
            seq = 0
            while not self._stop.is_set():
                task = self._sample_task(track=True)
                while not self._stop.is_set():
                    try:
                        self._task_q.put((seq, task), timeout=0.25)
                        seq += 1
                        break
                    except queue.Full:
                        continue

        def collect() -> None:
            pending: Dict[int, object] = {}
            expect = 0
            try:
                while not self._stop.is_set():
                    try:
                        seq, batch = self._result_q.get(timeout=0.25)
                    except queue.Empty:
                        if not all(p.is_alive() for p in self._procs):
                            raise RuntimeError("BatchLoader: a worker process died")
                        continue
                    pending[seq] = batch
                    while expect in pending:
                        batch = pending.pop(expect)
                        if isinstance(batch, _Failure):
                            raise batch.error
                        put(self._device_batch(batch, self._stream))
                        expect += 1
            except BaseException as e:  # handed to the consumer by next()
                put(_Failure(e))

        self._feeder = threading.Thread(target=feed, name="BatchLoader-feeder", daemon=True)
        self._thread = threading.Thread(target=collect, name="BatchLoader-collector",
                                        daemon=True)
        self._feeder.start()
        self._thread.start()

    def kill(self) -> None:
        """Stop the prefetch thread (and the workers, the feeder and the
        collector) and rewind the sampler to the next unconsumed batch:
        batches prefetched but never handed out are drawn again by whoever
        iterates next."""
        if self._thread is None:
            return
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the threads first: a worker stopped while it writes a batch would
        # leave the collector reading the rest of it forever
        if self._feeder is not None:
            self._feeder.join()
            self._feeder = None
        self._thread.join()
        self._thread = None
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join()
        if self._procs:
            # tasks still buffered for the dead workers must not hold the
            # parent's exit on the queue's feeder thread
            self._task_q.cancel_join_thread()
            self._task_q.close()
            self._result_q.close()
        self._procs = []
        self._transfer = None
        with self._state_lock:
            front = dict(self._inflight[0]) if self._inflight else None
            self._inflight.clear()
        if front is not None:
            self.load_state_dict(front)

    # -- batch assembly ----------------------------------------------------

    def _build_batch(self, task, stream=None) -> Dict[str, object]:
        return self._device_batch(
            _assemble_batch(self.dataset, self.cfg, self.augment, task, self.rows), stream)

    def _device_batch(self, batch: Dict[str, np.ndarray], stream=None) -> Dict[str, object]:
        """`_finalize` on `stream` (None: the current stream), with the event
        next() waits on."""
        if stream is None:
            return self._finalize(batch)
        with torch.cuda.stream(stream):
            batch = self._finalize(batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        batch["_ready"] = ready
        return batch

    def _finalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, object]:
        """The device work on an assembled host batch, on the current
        stream: the lidar raster (points up, raster stays there), the
        DEBUG.DRAW_MINIBATCH draws, then the optional transfer."""
        indices = batch.pop("_indices", None)
        if self._grid is not None and "points" in batch:
            points = host_to_device(batch.pop("points"), self.device)
            valid = host_to_device(batch.pop("point_valid"), self.device)
            self._timer.start()
            batch["data"] = voxelize_bev(points, valid, **self._grid)
            self.last_raster_ms = self._timer.stop()
            self.last_raster_thread = threading.current_thread().name
        if self.cfg.debug.draw_minibatch and indices is not None:
            self._draw_minibatch(batch, indices)
        if self._transfer is not None:
            batch = self._transfer(batch)
        return batch

    def _draw_minibatch(self, batch: Dict[str, object], indices: np.ndarray) -> None:
        """DEBUG.DRAW_MINIBATCH: each frame of the batch with its GT boxes,
        written to debug/minibatch_draws/mb_<epoch>_<cur>_<index>.png (ref
        minibatch.py:35-107; JAX loader :494-519, whose drawing this is)."""
        import os

        from faster_rcnn_pytorch_multimodal_tpu_torch.utils import visualization as viz

        out_dir = os.path.join("debug", "minibatch_draws")
        data = batch["data"]
        data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
        for i, idx in enumerate(indices):
            gt = batch["gt_boxes"][i][batch["gt_mask"][i]]
            if self.cfg.net_type == "lidar":
                canvas = viz.draw_detections_bev(data[i], np.zeros((0, 8)), gt7=gt)
            else:
                img = data[i] * np.asarray(self.cfg.pixel_stddevs) + np.asarray(
                    self.cfg.pixel_means)
                canvas = img[:, :, ::-1]
                if len(gt):
                    canvas = viz.draw_bounding_boxes(canvas, gt)
            viz.save_image(
                canvas, os.path.join(out_dir, f"mb_{self._epoch}_{self._cur}_{int(idx)}.png"))
