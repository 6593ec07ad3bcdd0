"""Tensor and spatial parallelism of the port (the model axis of parallel/:
the RoI tail's channels and the backbone's rows over MESH.MODEL ranks) on
the CPU: a (data 2 x model 2) mesh of 4 spawned ranks over gloo, a file://
rendezvous under the test's tmp path, one intra-op thread each
(tests/torch_model_parallel_ranks.py).  One group of ranks runs every
case; this process meanwhile runs JAX's (2, 2) mesh steps in a thread and
the one-process references and Solver runs in this one.

(a) Against JAX: the JAX model-parallel test's own cases (res18, 64x96,
float32, `tp` and `tp+sp`, tests/test_model_parallel.py:28-46) through
JAX's make_train_step on a (2, 2) make_mesh of 4 of the 8 virtual CPU
devices (state_shardings, shard_batch), a global batch of 4.  The ranks
take JAX's initial weights, their rows of JAX's draws and proposal lanes,
and step: losses within rtol 1e-5 (atol 1e-6), the updated parameters
(gathered whole) within rtol 1e-4 (atol 1e-5), the JAX test's bars; each
rank holds half of the tail's bytes; each leaf's shard dimension is the
one JAX's param_shardings gives it, in the port's layout.

(b) Against one port process on the same global batch, at the same bars:
FPN res18 tp+sp, VGG16 tp (fc6 / fc7 dropout live on the rank's
channels), BEV res18 tp+sp on 200 x 175 x 15 rasters (uneven row slabs at
stride 16), live BN tp+sp (running statistics within 1e-5 of their max),
res50 with every UC flag tp+sp, MobileNet tp+sp (depthwise convs on the
rank's rows, then on its channels), and MESH.SPATIAL with MESH.MODEL 1; and
serving (solver.detect, the MC samples) through the sharded tail of the
VGG16 and UC cases.

(c) Snapshots across mesh shapes: a Solver snapshot written at 2 x 2
resumes in one process, and one written by one process resumes at 2 x 2;
both runs' losses, and the 2 x 2 run's, equal the one-process run's
within rtol 1e-5.

Also the grid rule against JAX's Solver and make_mesh, shard_state_dict /
gather_state_dict round trips with their dims against JAX's
param_shardings on five nets, the row exchange's forward and gradient (a
float64 gradcheck of the global function on 3 ranks, uneven slabs, the
max-pool's -inf edge) and the multihost dry run at 1 x 2.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import BatchLoader as JBatchLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import SyntheticDataset as JSynthetic  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.parallel import mesh as j_mesh  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import solver as j_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.config import (  # noqa: E402
    cfg_from_list,
    default_config,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (  # noqa: E402
    FasterRCNN,
    init_detector,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    load_flax_variables,
    to_flax_variables,
)
from tests import torch_model_parallel_ranks as M  # noqa: E402
from tests.test_torch_port_fpn import _torch_layout  # noqa: E402
from tests.test_torch_port_live_bn_step import _stages_train  # noqa: E402
from tests.test_torch_port_parallel import _background, _save_whole  # noqa: E402
from tests.test_torch_port_train import _flat, jax_draws  # noqa: E402
from tests.torch_port_threads import two_threads  # noqa: E402, F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
STAT_TOL = 1e-5  # of a statistic's max
JAX_CASES = ("tp", "tp+sp")
# a JAX axis of a leaf -> the port's dim: HWIO -> OIHW, (I, O) -> (O, I)
TO_TORCH_DIM = {4: {3: 0, 2: 1, 0: 2, 1: 3}, 2: {1: 0, 0: 1}, 1: {0: 0}}


def _jax_dims(variables, jmesh, cfg) -> dict:
    """{port key: the dim JAX's param_shardings shards it on, or None}."""
    specs = j_mesh.param_shardings(variables, jmesh, cfg)
    out = {}
    for coll in specs:
        for path, sh in _flat(specs[coll]) if hasattr(specs[coll], "items") else ():
            leaf = variables[coll]
            for p in path:
                leaf = leaf[p]
            axes = [i for i, a in enumerate(sh.spec) if a == cfg.mesh.model_axis_name]
            ndim = np.ndim(leaf)
            out[flax_path_to_torch_key(path)] = TO_TORCH_DIM[ndim][axes[0]] if axes else None
    return out


def _jax_side(path: str, name: str) -> dict:
    """JAX's make_train_step on a (2, 2) mesh for the JAX test's case
    `name`, and the ranks' inputs for it written to `path` (renamed into
    place: the ranks wait for it)."""
    over = M.jax_overrides(name == "tp+sp")
    cfg = j_cfg_from_list(j_default(), over)
    ds = JSynthetic(cfg, num_frames=2 * M.JAX_B, num_classes=M.K, image_hw=(64, 96))
    loader = JBatchLoader(ds, cfg, batch_size=M.JAX_B, seed=0)
    model = j_det.FasterRCNN(cfg=cfg, num_classes=M.K)
    rng = jax.random.PRNGKey(0)
    state, opt = j_solver.create_train_state(model, cfg, rng, loader.peek())
    batch = {k: np.asarray(v) for k, v in loader.next().items()
             if k in ("data", "gt_boxes", "gt_mask", "window")}
    jmesh = j_mesh.make_mesh(cfg, jax.devices()[:4])
    assert dict(zip(jmesh.axis_names, jmesh.devices.shape)) == {"data": 2, "model": 2}
    sharded = jax.device_put(state, j_mesh.state_shardings(state, jmesh, cfg))
    step = j_solver.make_train_step(model, opt)
    new_state, losses = step(sharded, j_mesh.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, jmesh, cfg), rng)
    variables = jax.device_get(state.params)
    tcfg = cfg_from_list(default_config(), over)
    port = FasterRCNN(tcfg, M.K)
    load_flax_variables(port, variables)
    _rois, _a3d, valid, src = (np.asarray(a) for a in jax.jit(
        lambda v, d, w: model.apply(v, d, w, method=_stages_train))(
            variables, jnp.asarray(batch["data"]), jnp.asarray(batch["window"])))
    n, r = port.train_lane_counts(batch["data"].shape[1:3], tcfg.static.max_gt)
    draws = jax_draws(jax.random.fold_in(rng, jnp.int32(0)), M.JAX_B, n, r, tcfg.static.max_gt)
    _save_whole({"overrides": over, "state": port.state_dict(), "batch": batch,
                 "draws": tuple(draws), "lanes": (torch.from_numpy(src).long(),
                                                  torch.from_numpy(valid))}, path)
    new = jax.device_get(new_state.params)
    return dict(
        losses={k: float(v) for k, v in losses.items()},
        new_params={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(new["params"])},
        dims=_jax_dims(variables, jmesh, cfg),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's 2 x 2 step, the steps against JAX and the Solver runs
    (spawned ranks, from a thread); meanwhile JAX's mesh steps in a second
    thread and here the one-process Solver run (whose iter_1 the ranks
    resume from), the references, and the one-process resume from the
    ranks' iter_1."""
    out = str(tmp_path_factory.mktemp("mp_ranks"))
    paths = {name: os.path.join(out, f"jax_{name}.pt") for name in JAX_CASES}

    def jax_side():
        done = {}
        try:
            for name, path in paths.items():
                done[name] = _jax_side(path, name)
            return done
        except BaseException:  # the ranks wait for the files: let them go on
            for name, path in paths.items():
                if name not in done:
                    _save_whole({"error": "the JAX side failed"}, path)
            raise

    ranks = _background(spawn_ranks, M.step_cases, M.WORLD, out,
                        tuple(M.CASES) + ("jax", "solver"), timeout=600)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_join = _background(jax_side)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(sys.modules, "torch.utils.tensorboard", None)
                one = M.make_solver(os.path.join(out, "one"), None).train(M.SOLVER_STEPS)
                refs = {case: M.reference(case) for case in M.CASES}
                served = {case: M.reference_serving(case) for case in M.SERVE_CASES}
        finally:
            jax_run = jax_join()
        ranks()
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "torch.utils.tensorboard", None)
            from_mesh = M.resume(os.path.join(out, "mesh", "checkpoints", "iter_1"),
                                 os.path.join(out, "from_mesh"), None)
    finally:
        torch.set_num_threads(threads)
    got = {case: [torch.load(os.path.join(out, f"{case}_{r}.pt"), weights_only=False)
                  for r in range(M.WORLD)] for case in M.CASES}
    for name, path in paths.items():
        jax_run[name]["ranks"] = [torch.load(f"{path}.{r}", weights_only=False)
                                  for r in range(M.WORLD)]
    solver = [torch.load(os.path.join(out, f"solver_{r}.pt"), weights_only=False)
              for r in range(M.WORLD)]
    return dict(refs=refs, got=got, jax=jax_run, one=one, from_mesh=from_mesh, solver=solver,
                served=served)


def _close_losses(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **LOSS_TOL, err_msg=f"{what}: loss {k}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_step_equals_jax_mesh_step(runs, name):
    """(a) The 2 x 2 step against JAX's (2, 2) make_train_step: losses,
    every updated parameter, the tail's shards and their dims."""
    j = runs["jax"][name]
    ranks = j["ranks"]
    assert all(r["rows_split"] == (name == "tp+sp") for r in ranks)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"], "every rank reports the global losses"
        held, whole = r["tail_bytes"]
        assert 2 * held == whole > 0, "each rank holds half of the tail's bytes"
    for k in ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box", "total_loss"):
        np.testing.assert_allclose(ranks[0]["losses"][k], j["losses"][k], **LOSS_TOL,
                                   err_msg=f"{name}: loss {k}")
    params = ranks[0]["params"]
    compared = 0
    for key, want in j["new_params"].items():
        if key not in params:  # a frozen BN leaf: a buffer in the port
            continue
        np.testing.assert_allclose(params[key].numpy(), _torch_layout(want), **PARAM_TOL,
                                   err_msg=f"{name}: updated {key}")
        compared += 1
    assert compared >= 25  # the convs, RPN and predictors of res18 (its BN frozen)
    dims = ranks[0]["dims"]
    sharded = {k: d for k, d in j["dims"].items() if d is not None}
    assert dims == sharded, "the port shards what JAX's param_shardings shards, on the same axis"
    assert any(k.startswith("tail.") for k in dims) and any(
        k.startswith("predictors.") for k in dims)


@pytest.mark.parametrize("case", tuple(M.CASES))
def test_mesh_step_equals_one_process(runs, case):
    """(b) The 2 x 2 step (or, for m1, 4 data ranks with MESH.SPATIAL on a
    model axis of 1) against the one-process step on the same global batch:
    losses, updates, running statistics, sampled labels; the tail halved on
    every rank, the rows split where MESH.SPATIAL asks it."""
    want, got = runs["refs"][case], runs["got"][case]
    cfg = M.config(case)
    r0 = got[0]
    _close_losses(r0["losses"], want["losses"], case)
    for r in got:
        assert r["losses"] == r0["losses"], "every rank reports the global losses"
        held, whole = r["tail_bytes"]
        assert held * max(cfg.mesh.model, 1) == whole, (case, r["tail_bytes"])
        assert r["rows_split"] == (cfg.mesh.spatial and cfg.mesh.model > 1), case
    assert want["params"].keys() == r0["params"].keys()
    for k, v in want["params"].items():
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(), **PARAM_TOL,
                                   err_msg=f"{case}: updated {k}")
    assert want["stats"].keys() == r0["stats"].keys()
    assert bool(want["stats"]) == (case in ("bev", "live", "uc", "m1"))
    for k, v in want["stats"].items():
        err = float((r0["stats"][k] - v).abs().max() / v.abs().max())
        assert err <= STAT_TOL, (case, k, err)
    n_data = cfg.mesh.data
    for key in ("anchor_labels", "roi_labels"):
        rows = [got[d * max(cfg.mesh.model, 1)][key] for d in range(n_data)]
        assert torch.equal(torch.cat(rows), want[key]), (case, key)


@pytest.mark.parametrize("case", M.SERVE_CASES)
def test_serving_through_the_sharded_tail(runs, case):
    """solver.detect (the val detections' forward_test) on each rank's
    frames through the sharded tail, the T MC samples with their dropout
    masks on the rank's channels (VGG16 tp; res50 tp+sp, the RPN's samples
    of the backbone on its rows), against one process on the same frames
    and draws: every output within 1e-5 of its max, plus the float32
    rounding of what e_cls_var and the mutual informations cancel
    (chip_smoke.uc_slack); the integer and boolean outputs equal."""
    cfg = M.config(case)
    for r, rank in enumerate(runs["got"][case]):
        got, want = rank["served"], runs["served"][case][r // cfg.mesh.model]
        assert got.keys() == want.keys() and "uncertainties/e_entropy" in got
        for k, v in want.items():
            if not v.is_floating_point():
                assert torch.equal(got[k], v), (case, r, k)
                continue
            classes = 2 if k.startswith("rpn_") else M.K
            limit = 1e-5 * float(v.abs().max()) + M.chip_smoke.uc_slack(
                k.rsplit("/", 1)[-1], cfg.uc.e_num_sample, classes)
            assert float((got[k] - v).abs().max()) <= limit, (case, r, k)


def test_snapshots_resume_across_mesh_shapes(runs):
    """(c) Solver.train at 2 x 2 (res18 live BN tp+sp, the val cycle at step
    2) equals the one-process run; a new one-process Solver resuming from
    the 2 x 2 run's iter_1, and a 2 x 2 Solver resuming from the
    one-process run's iter_1, each repeat the uninterrupted step 2."""
    one = runs["one"]["history"]
    assert len(one) == M.SOLVER_STEPS
    for r in runs["solver"]:
        assert len(r["mesh"]) == M.SOLVER_STEPS
        for got, want in zip(r["mesh"], one):
            _close_losses(got, want, "2 x 2 Solver")
        assert len(r["from_one"]) == 1
        _close_losses(r["from_one"][0], one[1], "2 x 2 resumed from one process")
        assert 2 * r["tail_bytes"] == runs["one"]["tail_bytes"]
    assert len(runs["from_mesh"]) == 1
    _close_losses(runs["from_mesh"][0], one[1], "one process resumed from 2 x 2")


@pytest.mark.parametrize("model_axis", [1, 2, 4])
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 2, 4, 6, 8])
def test_grid_rule_follows_jax(model_axis, devices, batch, monkeypatch):
    """mesh_shape / data_world_size against the JAX Solver's rule with the
    model axis (solver.py:234-242, on `devices` stand-ins), for MESH.DATA
    -1 and every MESH.DATA up to the devices over m; JAX caps the data
    axis at the devices, the port lets ranks share a device (at least one
    data rank where the devices are fewer than m)."""
    from faster_rcnn_pytorch_multimodal_tpu.training import metrics as j_metrics

    monkeypatch.setattr(jax, "devices", lambda: list(range(devices)))
    monkeypatch.setattr(j_solver, "make_mesh", lambda cfg, devs: devs)
    monkeypatch.setattr(j_metrics, "MetricsWriter", lambda *a, **k: None)
    loader = type("Loader", (), {"batch_size": batch})()
    for data in [-1] + list(range(1, devices // model_axis + 1)):
        over = ("MESH.DATA", str(data), "MESH.MODEL", str(model_axis), "MESH.SPATIAL", "True")
        cfg = cfg_from_list(default_config(), over)
        n, m = mesh.mesh_shape(cfg, batch, devices)
        assert m == model_axis and batch % n == 0
        assert mesh.data_world_size(cfg, batch, devices) == n * m
        if devices >= model_axis:
            j = j_solver.Solver(j_cfg_from_list(j_default(), over), None, loader,
                                output_dir="x")
            assert n * m == len(j.mesh), (data, batch, devices, model_axis)


def test_rank_coordinates_follow_make_mesh():
    """Rank r is (r // m, r % m): where JAX's make_mesh puts device r of a
    process-major list in its (data, model) grid; a rank's rows are its
    data index's."""
    cfg = j_cfg_from_list(j_default(), ("MESH.MODEL", "2"))
    grid = j_mesh.make_mesh(cfg, jax.devices()[:8]).devices
    ids = {d.id: i for i, d in enumerate(jax.devices()[:8])}
    for rank in range(8):
        dp = mesh.DataParallel(rank, 8, torch.device("cpu"), model=2)
        assert ids[grid[dp.data_rank, dp.model_rank].id] == rank
        assert (dp.data_world, dp.size("model"), dp.size("all")) == (4, 2, 8)
        assert dp.rows(8) == mesh.local_batch_rows(rank // 2, 4, 8)


NETS = {
    "res18 C4 + UC": ("NET_VARIANT", "res18", "RESNET.FIXED_BLOCKS", "-1") + M.chip_smoke.UC_ALL_OVERRIDES,
    "res18 FPN": ("NET_VARIANT", "res18", "USE_FPN", "True", "POOLING_MODE", "multiscale"),
    "vgg16": ("NET_VARIANT", "vgg16", "POOLING_SIZE", "3") + M.chip_smoke.UC_OVERRIDES,
    "mobile": ("NET_VARIANT", "mobile", "MOBILENET.DEPTH_MULTIPLIER", "0.25"),
    "res50 lidar UC": ("NET_VARIANT", "res50", "NET_TYPE", "lidar", "RESNET.FIXED_BLOCKS", "-1")
    + M.chip_smoke.UC_OVERRIDES,
}


@pytest.mark.parametrize("net", tuple(NETS))
def test_state_dict_shards_follow_param_shardings(net):
    """shard_state_dict's dims on each net, leaf by leaf, are those JAX's
    param_shardings gives the same variables on a (2, 2) mesh (in the
    port's layout); gather_state_dict of the two shards is the whole state
    dict, bitwise; the shards halve the tail and split the predictors'
    inputs."""
    over = NETS[net] + ("MESH.MODEL", "2")
    tcfg = cfg_from_list(default_config(), over)
    model = init_detector(tcfg, 3, seed=0)
    full = model.state_dict()
    dims = tp.shard_dims({k: v.shape for k, v in full.items()}, 2)
    live = tcfg.resnet.fixed_blocks == -1 and not tcfg.net_variant == "mobile"
    variables = to_flax_variables(full, live_bn=live)
    cfg = j_cfg_from_list(j_default(), over)
    jmesh = j_mesh.make_mesh(cfg, jax.devices()[:4])
    assert _jax_dims(variables, jmesh, cfg) == dims
    shards = [tp.shard_state_dict(full, j, 2) for j in range(2)]
    back = tp.gather_state_dict(shards, dims)
    assert back.keys() == full.keys()
    assert all(torch.equal(back[k], full[k]) for k in full)
    for k, d in dims.items():
        if d is not None:
            assert shards[0][k].shape[d] * 2 == full[k].shape[d], k
    assert {k.split(".")[0] for k, d in dims.items() if d is not None} == {"tail", "predictors"}


def test_row_exchange_gradcheck_on_three_ranks(tmp_path):
    """The row exchange on 3 ranks of an 11-row map (slabs of 3, 4 and 4
    rows; outputs of 6 rows at stride 2: 2, 2 and 2): a 3x3 conv at strides
    1 and 2, a 1x1 stride-2 conv (rows 2o) and the stem's 3x3 stride-2
    max-pool (-inf beyond the map), in float64: each rank's output rows
    equal the whole map's within 1e-12, and the Jacobian its backward
    gives (every halo row's gradient sent to its owner) equals central
    differences of the global function within 1e-6."""
    spawn_ranks(M.halo_checks, M.HALO_WORLD, 11, str(tmp_path), timeout=300)
    for r in range(M.HALO_WORLD):
        errs = torch.load(tmp_path / f"halo_{r}.pt", weights_only=False)
        assert set(errs) == {name for name, *_ in M.halo_ops()}
        for name, (fwd, jac, shape) in errs.items():
            assert fwd <= 1e-12, (r, name, fwd)
            assert jac <= 1e-6, (r, name, jac)
            assert shape[2] > 0, (r, name, shape)


def test_multihost_dry_run_on_a_model_axis(tmp_path):
    """`python -m ...parallel.multihost --device cpu --set MESH.MODEL 2
    MESH.SPATIAL True` as 2 CPU processes (1 data x 2 model): the step
    equals the one-process step in every rank."""
    env = dict(os.environ, WORLD_SIZE="2", DP_INIT_METHOD=f"file://{tmp_path}/rdv",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost",
           "--device", "cpu", "--set", "MESH.MODEL", "2", "MESH.SPATIAL", "True"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), cwd=str(M.REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "multihost dryrun ok: 2 ranks = 1 data x 2 model" in outs[0], outs[0]
