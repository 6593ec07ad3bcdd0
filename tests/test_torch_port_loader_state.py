"""The port's BatchLoader sampler state and background prefetch against the
JAX package's loader (data/loader.py:200-249, :310-354, :412-441), on the
CPU: the state_dict after k batches, with and without the prefetch thread
(its queue full, so that the thread has drawn ahead of what next() handed
out), equals JAX's on the same synthetic image dataset, config and seed,
and the batches after a load_state_dict are bitwise equal to an
uninterrupted loader's and to JAX's.  Port-only: the LiDAR raster made in
the prefetch thread, kill() rewinding the sampler, and a failure in the
thread reaching next().
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from faster_rcnn_pytorch_multimodal_tpu import config as j_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import loader as j_loader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import synthetic as j_synth  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data import loader as t_loader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data import synthetic as t_synth  # noqa: E402

# multi-scale augmentation, so that the sampler also draws a scale a batch
IMAGE = ("NET_TYPE", "image", "STATIC.MAX_GT", "8", "TRAIN.SCALES", "(1.0, 0.5)")
BEV = ("NET_TYPE", "lidar", "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)",
       "STATIC.MAX_POINTS", "4096", "STATIC.MAX_GT", "8")
PREFETCH = 2


def _loaders(seed=11):
    jc = j_config.cfg_from_list(j_config.default_config(), IMAGE)
    tc = t_config.cfg_from_list(t_config.default_config(), IMAGE)
    jd = j_synth.SyntheticDataset(jc, num_frames=5, image_hw=(64, 96))
    td = t_synth.SyntheticDataset(tc, num_frames=5, image_hw=(64, 96))
    jl = j_loader.BatchLoader(jd, jc, batch_size=2, seed=seed, prefetch=PREFETCH, rasterize=False)
    tl = t_loader.BatchLoader(td, tc, batch_size=2, device="cpu", seed=seed, prefetch=PREFETCH)
    return jl, tl, td, tc


def _wait_full(loader, timeout=30.0):
    """Until the prefetch queue is full and the thread has drawn the task
    after it (blocked on the full queue)."""
    t0 = time.time()
    while not (loader._q.full() and len(loader._inflight) > PREFETCH):
        assert time.time() - t0 < timeout, "the prefetch queue never filled"
        time.sleep(0.01)


def _equal_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _equal_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("prefetch", [False, True], ids=["idle", "queue_full"])
@pytest.mark.parametrize("k", [1, 3])
def test_state_dict_equals_jax_and_resumes_bitwise(prefetch, k):
    """After k batches (3 crosses an epoch: 5 frames, batches of 2) the
    state of the next unconsumed batch equals JAX's; a fresh loader given it
    yields the uninterrupted loader's next batches and JAX's."""
    jl, tl, td, tc = _loaders()
    if prefetch:
        jl.start()
        tl.start()
    try:
        for _ in range(k):
            _equal_batch(tl.next(), jl.next())
        if prefetch:
            _wait_full(tl)
            _wait_full(jl)
            assert len(tl._inflight) == len(jl._inflight) > PREFETCH
        state = tl.state_dict()
        _equal_state(state, jl.state_dict())
        assert (int(state["cur"]), int(state["epoch"])) == ((2, 0) if k == 1 else (1, 1))
        resumed = t_loader.BatchLoader(td, tc, batch_size=2, device="cpu", seed=0)
        resumed.load_state_dict(state)
        _equal_state(resumed.state_dict(), state)
        for _ in range(3):
            want = jl.next()
            _equal_batch(tl.next(), want)
            _equal_batch(resumed.next(), want)
    finally:
        tl.kill()
        jl.kill()


def test_kill_rewinds_to_the_next_unconsumed_batch():
    """Batches the thread prefetched but next() never handed out are drawn
    again after kill(), on the caller's thread, as in JAX."""
    jl, tl, _, _ = _loaders(seed=5)
    tl.start()
    tl.next()
    _wait_full(tl)
    tl.kill()
    assert tl._thread is None and not tl._inflight
    jl.next()
    _equal_state(tl.state_dict(), jl.state_dict())
    for _ in range(2):
        _equal_batch(tl.next(), jl.next())


def test_start_refuses_another_transfer():
    _, tl, _, _ = _loaders()

    def first(b):
        return b

    tl.start(transfer=first)
    try:
        tl.start(transfer=first)
        with pytest.raises(RuntimeError):
            tl.start(transfer=lambda b: b)
    finally:
        tl.kill()


def test_a_failure_in_the_thread_reaches_next():
    _, tl, _, _ = _loaders()

    def boom(batch):
        raise ValueError("transfer failed")

    tl.start(transfer=boom)
    try:
        with pytest.raises(RuntimeError) as err:
            tl.next()
        assert isinstance(err.value.__cause__, ValueError)
    finally:
        tl.kill()


def test_lidar_raster_is_made_in_the_prefetch_thread():
    """The voxelizer (its twin on the CPU) runs in the prefetch thread, and
    the prefetched batches equal those made on the caller's thread."""
    cfg = t_config.cfg_from_list(t_config.default_config(), BEV)
    ds = t_synth.SyntheticDataset(cfg, num_frames=3, seed=0)
    plain = t_loader.BatchLoader(ds, cfg, batch_size=1, device="cpu", seed=2)
    pre = t_loader.BatchLoader(ds, cfg, batch_size=1, device="cpu", seed=2)
    pre.start()
    try:
        for _ in range(4):
            want, got = plain.next(), pre.next()
            assert plain.last_raster_thread == threading.current_thread().name
            assert pre.last_raster_thread == "BatchLoader-prefetch"
            assert tuple(got["data"].shape) == (1, 200, 175, 15)
            _equal_batch(got, want)
    finally:
        pre.kill()
