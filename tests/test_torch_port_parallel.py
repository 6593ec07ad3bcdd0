"""Data-parallel training of the port (parallel/, the loader's rows, the
global live-BN statistics, loss denominators and draws, the gradient sum,
the Solver's ranks) on the CPU: 2 ranks over gloo, a file:// rendezvous
under the test's tmp path, one intra-op thread each, against the one-process
step on the same global batch of 2 frames (tests/torch_parallel_ranks.py).
One group of ranks runs every case; this process meanwhile computes JAX's
step for the ranks' last case (in a thread) and the one-process references.

Bars: losses within rtol 1e-6 (atol 1e-6) and updated parameters within
rtol 1e-5 (atol 1e-6), tests/test_data_parallel.py's for JAX's 8-device
mesh; the running statistics within rtol 1e-5 (atol 1e-7); the sampled
labels and the replicas' checksums equal.

Twice against JAX: the 2-rank live-BN step (res18, every BN scale, bias and
running statistic randomized as tests/test_torch_port_live_bn.py does; the
"live" case's frames, then the "mixed" case's global batch of a 64x96 and
a 128x160 frame, JAX's step on the globally padded batch, each rank's
loader padding its row to it) against JAX's jitted step on a 2-device mesh of the 8
virtual CPU devices (tests/conftest.py).  One jit on the mesh gives JAX's
losses, gradients, the running statistics its forward_train leaves, its
train-mode proposal lanes, the intermediates the ReLU ties are read from
and the parameters after its optimizer chain.  The ranks take their rows
of JAX's draws (tests.test_torch_port_train.jax_draws) and lanes, and each
ReLU unit at 0 within rounding takes JAX's gate (chip_smoke.pinned_ties;
each rank collects its own against JAX's intermediates), as
tests/test_torch_port_live_bn_step.py pins them.  Bars: that test's (losses
rtol 1e-4, each leaf's gradient and update within 1e-3 of its max, the
running statistics within 1e-5 of max).

Also the JAX package's rules: the row split and the world-size divisor
rule, and the model axis's settings accepted and planned.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import chip_smoke  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.config import (  # noqa: E402
    cfg_from_list,
    default_config,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import FasterRCNN  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    load_flax_variables,
    to_flax_variables,
)
from tests import torch_parallel_ranks as R  # noqa: E402
from tests.test_torch_port_fpn import _jax_site, _torch_layout  # noqa: E402
from tests.test_torch_port_live_bn import _close, _randomize_bn  # noqa: E402
from tests.test_torch_port_live_bn_step import _stages_train  # noqa: E402
from tests.test_torch_port_train import _flat, jax_draws  # noqa: E402

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
STAT_TOL = dict(rtol=1e-5, atol=1e-7)


CASE = "live"
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box", "total_loss")


def _jax_mesh_step(cfg, variables, batch, step_rng):
    """One jit on a (2,) data mesh: forward_train's losses, the gradients,
    the batch statistics it leaves and its intermediates, the train-mode
    proposal lanes (_stages_train), and the parameters JAX's
    make_train_step leaves: its optimizer chain on these gradients, the
    whole variables tree as its state holds it (the statistics frozen), as
    tests/test_torch_port_live_bn_step.py applies it."""
    model = j_det.FasterRCNN(cfg=cfg, num_classes=R.K)
    opt = j_optim.build_optimizer(variables, cfg)
    dmesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    rows, repl = NamedSharding(dmesh, P("data")), NamedSharding(dmesh, P())
    keys = ("data", "gt_boxes", "gt_mask", "window")
    jb = [jax.device_put(jnp.asarray(batch[k]), rows) for k in keys]
    params, stats = (jax.device_put(variables[c], repl) for c in ("params", "batch_stats"))

    @jax.jit
    def run(params, stats, data, gt, mask, window):
        def total(p):
            losses, state = model.apply(
                {"params": p, "batch_stats": stats}, data, gt, mask, window, step_rng,
                method=j_det.FasterRCNN.forward_train, capture_intermediates=True,
                mutable=["intermediates", "batch_stats"])
            return losses["total_loss"], (losses, state)

        (_, (losses, state)), g = jax.value_and_grad(total, has_aux=True)(params)
        v = {"params": params, "batch_stats": stats}
        lanes = model.apply(v, data, window, method=_stages_train)
        updates, _ = opt.update({"params": g, "batch_stats": jax.tree.map(jnp.zeros_like, stats)},
                                opt.init(v), v)
        new_params = optax.apply_updates(params, updates["params"])
        return losses, g, state["batch_stats"], state["intermediates"], lanes, new_params

    return run(params, stats, *jb)


def _save_whole(obj, path):
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _jax_side(path, case=CASE):
    """JAX's mesh step on `case` (live BN) with randomized BN, and the ranks'
    inputs for it written to `path` (renamed into place: the ranks wait for
    it).  Returns what the test compares the ranks with."""
    cfg, tcfg = j_cfg_from_list(j_default(), R.CASES[case]), R.config(case)
    port = R.model_for(tcfg, case)
    variables = _randomize_bn(to_flax_variables(port.state_dict(), live_bn=True), seed=0)
    load_flax_variables(port, variables)
    batch = {k: v for k, v in R.global_batch(tcfg, case).items() if not k.startswith("_")}
    step_rng = jax.random.fold_in(jax.random.PRNGKey(3), jnp.int32(0))
    losses, g, stats, inter, lanes, new_params = _jax_mesh_step(cfg, variables, batch, step_rng)
    _rois, _a3d, valid, src = (np.asarray(a) for a in lanes)
    n, r = port.train_lane_counts(batch["data"].shape[1:3], tcfg.static.max_gt)
    draws = jax_draws(step_rng, R.B, n, r, tcfg.static.max_gt)
    pin = (torch.from_numpy(src).long(), torch.from_numpy(valid))
    sites = {}
    for site, residual in chip_smoke.relu_sites(port):
        jx = _jax_site(inter, site, residual)
        sites[(site, residual)] = np.ascontiguousarray(
            np.transpose(jx, (0, 3, 1, 2)) if jx.ndim == 4 else jx)  # the port's NCHW
    _save_whole({"case": case, "state": port.state_dict(), "batch": batch,
                 "draws": tuple(draws), "lanes": pin, "sites": sites}, path)
    key = flax_path_to_torch_key
    return dict(
        start={k: v.clone() for k, v in port.state_dict().items()},
        losses={k: float(v) for k, v in losses.items()},
        grads={key(p): np.asarray(v) for p, v in _flat(g)},
        stats={key(p): np.asarray(v) for p, v in _flat(stats)},
        new_params={key(p): np.asarray(v) for p, v in _flat(new_params)},
    )


def _background(fn, *args, **kwargs):
    """fn(*args, **kwargs) started in a thread; the returned join() waits
    for it and gives its value, or raises its exception."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # raised by join(), in the caller's thread
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's 2-rank step, the pinned live-BN step and the Solver runs
    (spawned ranks, from a thread), and meanwhile here JAX's mesh step in a
    second thread (the pinned step's inputs first: the ranks wait for
    them) and in this one the one-process steps, the unequal case's local
    means and the one-process Solver run."""
    out = str(tmp_path_factory.mktemp("dp_ranks"))
    jax_paths = {c: os.path.join(out, name) for c, name in (
        (CASE, R.JAX_INPUTS), ("mixed", R.JAX_MIXED_INPUTS))}

    def jax_side():
        done = {}
        try:
            for case, path in jax_paths.items():
                done[case] = _jax_side(path, case)
            return done
        except BaseException:  # the ranks wait for the files: let them go on
            for case, path in jax_paths.items():
                if case not in done:
                    _save_whole({"error": "the JAX side failed"}, path)
            raise

    ranks = _background(spawn_ranks, R.step_cases, 2, out, R.STEP_CASES + ("jax", "solver"),
                        timeout=600)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_join = _background(jax_side)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(sys.modules, "torch.utils.tensorboard", None)
                refs = {case: R.reference(case) for case in R.STEP_CASES}
                naive = R.naive_local_means("unequal")
                one_dir = os.path.join(out, "one")
                one = R.make_solver(one_dir, None).train(R.SOLVER_STEPS)
                one_val = R.val_scalars(one_dir)
        finally:
            jax_run = jax_join()
    finally:
        torch.set_num_threads(threads)
        ranks()
    got = {case: [torch.load(os.path.join(out, f"{case}_{r}.pt"), weights_only=False)
                  for r in range(2)] for case in R.STEP_CASES}
    solver = [torch.load(os.path.join(out, f"solver_{r}.pt"), weights_only=False)
              for r in range(2)]
    for case, path in jax_paths.items():
        jax_run[case]["ranks"] = [torch.load(f"{path}.{r}", weights_only=False)
                                  for r in range(2)]
    return dict(out=out, refs=refs, got=got, naive=naive, one=one["history"], one_val=one_val,
                solver=solver, jax=jax_run[CASE], jax_mixed=jax_run["mixed"])


def _close_losses(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **LOSS_TOL, err_msg=f"{what}: loss {k}")


@pytest.mark.parametrize("case", ["frozen", "live", "uc", "bev", "fpn", "mixed"])
def test_two_ranks_equal_one_process(runs, case):
    """(i) frozen C4, (ii) live-BN C4 with its running statistics, (iv)
    every UC flag with the dropout masks and normals split by rows, (v) BEV
    (K3, K1, K2 through their twins), (vi) FPN, (x) live BN on frames of
    two sizes, each rank's own frames of another size (each rank's loader
    pads to the global batch's bucket, serially, in its prefetch thread and
    in a worker: torch_parallel_ranks.mixed_loaders): the 2-rank step
    equals the one-process step on the same global batch."""
    want, (r0, r1) = runs["refs"][case], runs["got"][case]
    _close_losses(r0["losses"], want["losses"], case)
    assert r1["losses"] == r0["losses"], "every rank reports the same global losses"
    for k, v in want["params"].items():
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(), **PARAM_TOL,
                                   err_msg=f"{case}: updated {k}")
    assert want["stats"].keys() == r0["stats"].keys()
    assert bool(want["stats"]) == (case in ("live", "uc", "bev", "mixed"))
    for k, v in want["stats"].items():
        np.testing.assert_allclose(r0["stats"][k].numpy(), v.numpy(), **STAT_TOL,
                                   err_msg=f"{case}: running statistic {k}")
    for key in ("anchor_labels", "roi_labels"):
        assert torch.equal(torch.cat([r0[key], r1[key]]), want[key]), (case, key)
    assert r0["checksum"] == r1["checksum"], "the replicas differ after the step"


def test_unequal_counts_need_global_denominators(runs):
    """(iii) The second rank's rows hold fewer valid anchors and GT boxes:
    per-rank local means, averaged, miss the one-process RPN loss; the
    ranks' global denominators give it."""
    want = runs["refs"]["unequal"]["losses"]
    valid = [(r["anchor_labels"] >= 0).sum().item() for r in runs["got"]["unequal"]]
    assert valid[0] != valid[1], valid
    naive = runs["naive"]["rpn_cross_entropy"]
    assert abs(naive - want["rpn_cross_entropy"]) > 1e-3 * abs(want["rpn_cross_entropy"]), (
        naive, want["rpn_cross_entropy"])
    for k in ("rpn_loss_box", "cross_entropy", "loss_box"):  # the plain means agree
        np.testing.assert_allclose(runs["naive"][k], want[k], **LOSS_TOL, err_msg=k)
    _close_losses(runs["got"]["unequal"][0]["losses"], want, "unequal")
    for k, v in runs["refs"]["unequal"]["params"].items():
        np.testing.assert_allclose(runs["got"]["unequal"][0]["params"][k].numpy(), v.numpy(),
                                   **PARAM_TOL, err_msg=f"unequal: updated {k}")


def test_solver_stops_every_rank_and_resumes(runs):
    """(vii) Two ranks through Solver.train for 2 steps (live BN, the val
    cycle at step 2 with its losses and activation statistics): the
    uninterrupted run's losses and val scalars equal the one-process
    Solver's.  SIGTERM to rank 1 alone during its first step stops both
    ranks after step 1 with the snapshot iter_1 (and no other), and a new
    Solver resuming from it repeats the uninterrupted run bitwise."""
    s0, s1 = runs["solver"]
    assert len(s0["a"]) == R.SOLVER_STEPS and s0["a"] == s1["a"]
    for got, want in zip(s0["a"], runs["one"]):
        _close_losses(got, want, "Solver.train")
    val = R.val_scalars(os.path.join(runs["out"], "a"))
    assert [v["step"] for v in val] == [v["step"] for v in runs["one_val"]] == [2]
    for got, want in zip(val, runs["one_val"]):
        assert got.keys() == want.keys() and "act_conv0/std" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"val {k}")
    with open(os.path.join(runs["out"], "a", "tb", "scalars.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [2], "rank 0 alone logs"
    assert len(s0["a_reduce_ms"]) == R.SOLVER_STEPS
    assert s0["stopped_at"] == s1["stopped_at"] == 1
    assert s0["left"] == s1["left"] == ["iter_1"]
    assert s0["stopped_history"] == s0["a"][:1]
    assert s0["b"] == s0["a"][1:] and s1["b"] == s1["a"][1:]


def test_two_ranks_equal_jax_mesh_step(runs):
    """Losses, every trainable leaf's summed gradient, the running
    statistics and the update of the 2-rank live-BN step against JAX's
    step on its 2-device mesh."""
    _check_jax_mesh_step(runs["jax"])


def test_mixed_frame_sizes_equal_jax_mesh_step(runs):
    """The same on the mixed case's global batch of a 64x96 and a 128x160
    frame: JAX's one-process 2-device mesh step on the globally padded
    batch (128x192), the ranks each on their row, padded to it."""
    assert runs["jax_mixed"]["ranks"][0]["shape"] == (1, 128, 192, 3)
    _check_jax_mesh_step(runs["jax_mixed"])


def _check_jax_mesh_step(jax_run):
    """test_two_ranks_equal_jax_mesh_step's checks on one case's run."""
    r0, r1 = jax_run["ranks"]
    print(f"ReLU ties pinned by rank: {len(r0['ties'])}, {len(r1['ties'])}")
    for path, residual, at, jx, tx, scale in r0["ties"] + r1["ties"]:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale, (path, residual, at, jx, tx, scale)
    assert len(r0["ties"]) + len(r1["ties"]) <= 24
    assert r0["losses"] == r1["losses"]
    for k in LOSSES:
        np.testing.assert_allclose(r0["losses"][k], jax_run["losses"][k], rtol=1e-4, err_msg=k)
        assert jax_run["losses"][k] > 0, k
    assert set(r0["grads"]) == set(jax_run["grads"])
    for name, got in r0["grads"].items():
        want = _torch_layout(jax_run["grads"][name])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=name)
    assert set(r0["stats"]) == set(jax_run["stats"])
    for name, want in jax_run["stats"].items():
        _close(r0["stats"][name].numpy(), want, 1e-5, name)
        assert not np.array_equal(want, jax_run["start"][name].numpy()), name
    start = jax_run["start"]
    for name, p in r0["params"].items():
        want = _torch_layout(jax_run["new_params"][name]) - start[name].numpy()
        got = (p - start[name]).numpy()
        atol = 1e-3 * np.abs(want).max() + 1e-6 * np.abs(start[name].numpy()).max()
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


def test_loader_rows_in_the_prefetch_thread_and_a_worker():
    """A rank's loader (row 1 of each global batch of 2) hands out the
    global batches' rows, serially, from the prefetch thread and from a
    worker process, and its sampler state is the global loader's."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader

    cfg = R.config("frozen")
    full = BatchLoader(R.dataset(cfg), cfg, R.B, device="cpu", seed=0)
    want = [full.next() for _ in range(3)]
    for workers in (None, 0, 1):
        rank = BatchLoader(R.dataset(cfg), cfg, R.B, device="cpu", seed=0, rows=slice(1, 2),
                           workers=workers or 0)
        if workers is not None:
            rank.start()
        try:
            for w in want:
                got = rank.next()
                for k in ("data", "gt_boxes", "gt_mask", "window"):
                    np.testing.assert_array_equal(got[k], w[k][1:2], err_msg=f"{workers} {k}")
        finally:
            rank.kill()
        state, ref = rank.state_dict(), full.state_dict()
        assert state.keys() == ref.keys() and all(np.array_equal(state[k], ref[k]) for k in ref)


def test_a_failed_rank_fails_the_launcher():
    """spawn_ranks: one rank's exception stops the rank waiting for it in a
    collective and reaches the caller with its traceback; nothing passes
    silently."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*fails on purpose"):
        spawn_ranks(R.failing_rank, 2, timeout=120)


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("batch", [1, 2, 4, 6, 8, 12])
def test_world_size_and_rows_follow_jax(devices, batch, monkeypatch):
    """(viii) data_world_size against the JAX Solver's rule (solver.py:234-242,
    run on `devices` stand-in devices) for MESH.DATA -1 and every MESH.DATA
    up to the devices; local_batch_rows against JAX's multihost."""
    from faster_rcnn_pytorch_multimodal_tpu.parallel import multihost as j_multihost
    from faster_rcnn_pytorch_multimodal_tpu.training import metrics as j_metrics
    from faster_rcnn_pytorch_multimodal_tpu.training import solver as j_solver

    monkeypatch.setattr(jax, "devices", lambda: list(range(devices)))
    monkeypatch.setattr(j_solver, "make_mesh", lambda cfg, devs: devs)
    monkeypatch.setattr(j_metrics, "MetricsWriter", lambda *a, **k: None)
    loader = type("Loader", (), {"batch_size": batch})()
    for data in [-1] + list(range(1, devices + 1)):
        over = ("MESH.DATA", str(data))
        j = j_solver.Solver(j_cfg_from_list(j_default(), over), None, loader, output_dir="x")
        cfg = cfg_from_list(default_config(), over)
        assert mesh.data_world_size(cfg, batch, devices) == len(j.mesh), (data, batch, devices)
    world = mesh.data_world_size(cfg_from_list(default_config(), ("MESH.DATA", "-1")), batch,
                                 devices)
    for rank in range(world):
        assert mesh.local_batch_rows(rank, world, batch) == j_multihost.local_batch_rows(
            rank, world, batch)


def test_mesh_data_above_the_devices_shares_them():
    """Where JAX caps MESH.DATA at the devices, the port runs that many
    ranks on them (two ranks on one card, over gloo)."""
    cfg = cfg_from_list(default_config(), ("MESH.DATA", "2"))
    assert mesh.data_world_size(cfg, 8, 1) == 2
    assert mesh.backend_for(2, 1, "cuda")[0] == "gloo"
    assert mesh.backend_for(2, 2, "cuda")[0] == "nccl"
    assert mesh.backend_for(2, 0, "cpu")[0] == "gloo"
    with pytest.raises(ValueError, match="plans 2: set MESH.DATA 4"):
        mesh.init_data_parallel(cfg, 8, rank=0, world=4, device="cpu")


@pytest.mark.parametrize("over", [("MESH.MODEL", "2"), ("MESH.SPATIAL", "True")])
def test_model_axis_raises(over):
    """(ix) Tensor and spatial parallelism are ported (they raised before,
    naming ROADMAP A4): the detector builds, and the grid plans the model
    axis: MESH.MODEL 2 on one GPU is a 1 x 2 mesh (the ranks share it),
    MESH.SPATIAL alone a no-op on a model axis of 1
    (tests/test_torch_port_model_parallel.py holds the steps)."""
    cfg = cfg_from_list(default_config(), ("NET_VARIANT", "res18") + over)
    FasterRCNN(cfg, 2)
    m = cfg.mesh.model
    assert mesh.mesh_shape(cfg, 8, 1) == (1, m)
    assert mesh.data_world_size(cfg, 8, 1) == m
    assert mesh.data_world_size(cfg, 8, 4) == 4 // m * m
