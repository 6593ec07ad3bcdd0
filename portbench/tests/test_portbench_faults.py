"""A run with the timed path broken underneath comes out not correct: the
harness drives a tiny cell on the CPU (past its look for a card) with one
fault planted in the program at a time."""

import json

import pytest
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch import inference
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import FasterRCNN, TrainDraws
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged: no update, no momentum."""
    monkeypatch.setattr(DetectorSGD, "step", lambda self: torch.zeros(()))


def momentum_only(monkeypatch):
    """A step that fills the optimizer's momentum but writes no parameter."""
    step = DetectorSGD.step

    def kept(self):
        before = [p.detach().clone() for p in self.params]
        norm = step(self)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(b)
        return norm

    monkeypatch.setattr(DetectorSGD, "step", kept)


def half_batch_train(monkeypatch):
    """Half of the batch left out, the losses' means taken over the rest."""
    forward = FasterRCNN.forward_train

    def half(self, images, gt_boxes, gt_mask, window, draws, **kw):
        h = images.shape[0] // 2
        d = TrainDraws(*(t[:h] if torch.is_tensor(t) else t for t in draws))
        kw = {k: v[:h] if torch.is_tensor(v) else v for k, v in kw.items()}
        losses, aux = forward(self, images[:h], gt_boxes[:h], gt_mask[:h], window[:h], d, **kw)
        twice = [torch.cat([t, t]) for t in (aux.proposal_src, aux.proposal_valid)]
        return losses, aux._replace(proposal_src=twice[0], proposal_valid=twice[1])

    monkeypatch.setattr(FasterRCNN, "forward_train", half)


def half_batch_serve(monkeypatch):
    """Half of the batch left out: the first half's detections stand for all."""
    detect = inference.detect_batch

    def half(model, batch, draws=None):
        h = batch["data"].shape[0] // 2
        out = detect(model, {"data": batch["data"][:h], "window": batch["window"][:h]}, draws)
        return {k: torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(inference, "detect_batch", half)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: one kept detection's score."""
    filt = inference.filter_batch

    def altered(model, out, thresh):
        res = dict(filt(model, out, thresh))
        res["scores"] = res["scores"].clone()
        f, c, m = [int(i[0]) for i in torch.nonzero(res["valid"], as_tuple=True)]
        res["scores"][f, c, m] += 1e-3
        return res

    monkeypatch.setattr(inference, "filter_batch", altered)


FAULTS = [(unchanged_state, "train"), (momentum_only, "train"), (half_batch_train, "train"),
          (half_batch_serve, "serve"), (altered_answer, "serve")]
TRAIN_FAULTS = [f for f, path in FAULTS if path == "train"]


@pytest.fixture(scope="module")
def own_root(tmp_path_factory):
    """The tiny training cells judged by only the numbers that their
    full-size cell (`<kind>_train_b16`) compares."""
    limits = dict(tiny.LIMITS)
    for kind in ("image", "bev"):
        name = f"tiny_{kind}_train"
        keys = json.loads((tiny.REPO / "portbench/limits" / f"{kind}_train_b16.json").read_text())
        limits[name] = {k: tiny.LIMITS[name][k] for k in keys}
    return tiny.build(tmp_path_factory.mktemp("own"), limits)


@pytest.mark.parametrize("kind", ["image", "bev"])
@pytest.mark.parametrize("fault,path", FAULTS, ids=[f.__name__ for f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, kind, fault, path):
    fault(monkeypatch)
    res = tiny.run(root, f"tiny_{kind}_{path}")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["image", "bev"])
@pytest.mark.parametrize("fault", TRAIN_FAULTS, ids=[f.__name__ for f in TRAIN_FAULTS])
def test_a_broken_step_fails_the_full_size_cells_numbers(own_root, monkeypatch, kind, fault):
    fault(monkeypatch)
    res = tiny.run(own_root, f"tiny_{kind}_train")
    assert not res["correct"], res["checks"]
