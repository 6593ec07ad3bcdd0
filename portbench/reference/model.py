"""The reference detector: Faster R-CNN with a ResNet C4 backbone, on camera
frames or LiDAR BEV rasters, written as plain functions of a parameter
dict, in float32 (TF32 off); a quantizer can round every GEMM's operands
and output gradient (the control computes in fp8).

It follows the port's `models/detector.py` (C4 path, frozen BN, no
uncertainty), `models/resnet.py`, `models/heads.py`, the loss assembly of
`forward_train` and the optimizer chain of `training/optim.py` (global-norm
clip, weight decay on weights, SGD momentum), and shares no code with them.
The parameter names are the port's state-dict keys, so one dict of weights
made by the benchmark loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import ops
from .config import DEPTHS

# a lower precision for the control: operand(x) rounds a GEMM's inputs, output(y)
# its output's gradient (portbench.judge.Fp8)
Quant = Optional[object]
TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2
TERMINATOR_SCALE = 0.25  # residual terminators' BN scale, so random res101 stays finite


class Spec(NamedTuple):
    key: str
    shape: Tuple[int, ...]
    init: str  # "trunc" (truncated normal), "normal", "one", "zero", "terminator"
    std: float
    trainable: bool


# -- the parameters -----------------------------------------------------------------


def _blocks(cfg) -> Tuple[Tuple[int, ...], bool]:
    return DEPTHS[cfg["NET_VARIANT"]]


def _stage(prefix, cin, planes, n, stride, basic, frozen) -> Tuple[List[Spec], int, list]:
    """Specs of one layerN stage and its block plan [(key, cin, stride, has_ds)]."""
    exp = 1 if basic else 4
    specs, plan = [], []
    for i in range(n):
        s = stride if i == 0 else 1
        ds = i == 0 and (s != 1 or cin != planes * exp)
        k = f"{prefix}.{i}"
        plan.append((k, cin, s, ds))
        convs = ([("conv1", planes, cin, 3), ("conv2", planes, planes, 3)] if basic else
                 [("conv1", planes, cin, 1), ("conv2", planes, planes, 3),
                  ("conv3", planes * exp, planes, 1)])
        for j, (name, cout, ci, kk) in enumerate(convs, 1):
            specs.append(Spec(f"{k}.{name}.weight", (cout, ci, kk, kk), "trunc",
                              math.sqrt(2.0 / (cout * kk * kk)), not frozen))
            last = j == len(convs)
            specs += _bn_specs(f"{k}.bn{j}", cout, terminator=last)
        if ds:
            specs.append(Spec(f"{k}.downsample.0.weight", (planes * exp, cin, 1, 1), "trunc",
                              math.sqrt(2.0 / (planes * exp)), not frozen))
            specs += _bn_specs(f"{k}.downsample.1", planes * exp)
        cin = planes * exp
    return specs, cin, plan


def _bn_specs(prefix, c, terminator=False) -> List[Spec]:
    return [Spec(f"{prefix}.weight", (c,), "terminator" if terminator else "one", 0.0, False),
            Spec(f"{prefix}.bias", (c,), "zero", 0.0, False),
            Spec(f"{prefix}.running_mean", (c,), "zero", 0.0, False),
            Spec(f"{prefix}.running_var", (c,), "one", 0.0, False)]


class Arch(NamedTuple):
    specs: List[Spec]
    plans: Dict[str, list]  # stage name -> block plan
    basic: bool
    c4: int  # channels of the C4 map
    fc7: int  # channels out of the tail
    anchors: int


def architecture(cfg, num_classes: int) -> Arch:
    """Every parameter and buffer of the detector, with its init and whether
    it trains (RESNET.FIXED_BLOCKS freezes the stem and layer1..n, BN never
    trains)."""
    blocks, basic = _blocks(cfg)
    fixed = cfg["RESNET.FIXED_BLOCKS"]
    if fixed < 0:
        raise NotImplementedError("the reference detector has frozen BN only")
    lidar = cfg["NET_TYPE"] == "lidar"
    cin = cfg["LIDAR.NUM_SLICES"] + cfg["LIDAR.NUM_META_CHANNEL"] if lidar else 3
    specs = [Spec("backbone.conv1.weight", (64, cin, 7, 7), "trunc", math.sqrt(1.0 / (cin * 49)),
                  False)] + _bn_specs("backbone.bn1", 64)
    plans = {}
    c = 64
    for i, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2)), 1):
        s, c, plans[f"layer{i}"] = _stage(f"backbone.layer{i}", c, planes, blocks[i - 1], stride,
                                          basic, frozen=i <= fixed)
        specs += s
    c4 = c
    s, fc7, plans["layer4"] = _stage("tail.layer4", c4, 512, blocks[3], 1, basic, frozen=False)
    specs += s
    a = (len(cfg["LIDAR.ANCHORS"]) * len(cfg["LIDAR.ANCHOR_ANGLES"]) if lidar
         else len(cfg["ANCHOR_SCALES"]) * len(cfg["ANCHOR_RATIOS"]))
    rc = cfg["RPN_CHANNELS"]
    elem = 7 if lidar else 4
    for key, shape, std in (("rpn.rpn_net", (rc, c4, 3, 3), 0.01),
                            ("rpn.rpn_cls_score_net", (2 * a, rc, 1, 1), 0.01),
                            ("rpn.rpn_bbox_pred_net", (4 * a, rc, 1, 1), 0.01),
                            ("predictors.cls_score_net", (num_classes, fc7), 0.01),
                            ("predictors.bbox_pred_net", (elem * num_classes, fc7), 0.001)):
        specs += [Spec(f"{key}.weight", shape, "normal", std, True),
                  Spec(f"{key}.bias", (shape[0],), "zero", 0.0, True)]
    return Arch(specs, plans, basic, c4, fc7, a)


def make_weights(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 weights of `seed`, made on `device` by one generator in
    two large draws (every truncated normal, then every normal), each leaf a
    slice scaled by its std."""
    g = torch.Generator(device=device).manual_seed(ops.seed_of(seed, 0x77E16))
    sizes = {k: [s for s in arch.specs if s.init == k] for k in ("trunc", "normal")}
    flat = {}
    for kind, specs in sizes.items():
        n = sum(math.prod(s.shape) for s in specs)
        buf = torch.empty(n, device=device)
        if kind == "trunc":
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=g)
        else:
            buf.normal_(0.0, 1.0, generator=g)
        flat[kind] = buf
    out, offset = {}, {"trunc": 0, "normal": 0}
    for s in arch.specs:
        if s.init in flat:
            n = math.prod(s.shape)
            o = offset[s.init]
            scale = s.std / TRUNC if s.init == "trunc" else s.std
            out[s.key] = (flat[s.init][o:o + n] * scale).reshape(s.shape)
            offset[s.init] = o + n
        else:
            value = {"one": 1.0, "zero": 0.0, "terminator": TERMINATOR_SCALE}[s.init]
            out[s.key] = torch.full(s.shape, value, device=device)
    return out


# -- the network ----------------------------------------------------------------------


def _conv(x, P, key, stride=1, pad=0, q: Quant = None, bias=False):
    w = P[key + ".weight"]
    if q is None:
        return F.conv2d(x, w, P[key + ".bias"] if bias else None, stride, pad)
    return q.output(F.conv2d(q.operand(x), q.operand(w), P[key + ".bias"] if bias else None,
                             stride, pad))


def _bn(x, P, key):
    inv = torch.rsqrt(P[key + ".running_var"] + 1e-5) * P[key + ".weight"]
    shift = P[key + ".bias"] - P[key + ".running_mean"] * inv
    return x * inv[None, :, None, None] + shift[None, :, None, None]


def _block(x, P, k, stride, ds, basic, caffe, q):
    idt = _bn(_conv(x, P, k + ".downsample.0", stride, q=q), P, k + ".downsample.1") if ds else x
    if basic:
        o = torch.relu(_bn(_conv(x, P, k + ".conv1", stride, 1, q), P, k + ".bn1"))
        o = _bn(_conv(o, P, k + ".conv2", 1, 1, q), P, k + ".bn2")
    else:
        s1, s2 = (stride, 1) if caffe else (1, stride)
        o = torch.relu(_bn(_conv(x, P, k + ".conv1", s1, q=q), P, k + ".bn1"))
        o = torch.relu(_bn(_conv(o, P, k + ".conv2", s2, 1, q), P, k + ".bn2"))
        o = _bn(_conv(o, P, k + ".conv3", q=q), P, k + ".bn3")
    return torch.relu(o + idt)


def _stage_fwd(x, P, arch, name, q, caffe):
    for k, _cin, s, ds in arch.plans[name]:
        x = _block(x, P, k, s, ds, arch.basic, caffe, q)
    return x


def backbone(P, arch, x, q: Quant = None):
    """NCHW input -> the stride-16 C4 map: stem, layer1..3 (layers 2 and 3
    put their stride on the first 1x1 conv)."""
    x = torch.relu(_bn(_conv(x, P, "backbone.conv1", 2, 3, q), P, "backbone.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    x = _stage_fwd(x, P, arch, "layer1", q, caffe=False)
    x = _stage_fwd(x, P, arch, "layer2", q, caffe=True)
    return _stage_fwd(x, P, arch, "layer3", q, caffe=True)


def rpn(P, arch, feat, q: Quant = None):
    """C4 map -> logits (B, N, 2), fg probability (B, N), deltas (B, N, 4) in
    (y, x, anchor) lane order."""
    x = torch.relu(_conv(feat, P, "rpn.rpn_net", 1, 1, q, bias=True))
    cls = _conv(x, P, "rpn.rpn_cls_score_net", q=q, bias=True)
    box = _conv(x, P, "rpn.rpn_bbox_pred_net", q=q, bias=True)
    b, _, h, w = cls.shape
    a = arch.anchors
    logits = cls.permute(0, 2, 3, 1).reshape(b, h, w, 2, a).transpose(3, 4).reshape(b, -1, 2)
    return logits, torch.softmax(logits, -1)[..., 1], box.permute(0, 2, 3, 1).reshape(b, -1, 4)


def _linear(x, P, key, q: Quant):
    w = P[key + ".weight"]
    if q is None:
        return x @ w.t() + P[key + ".bias"]
    return q.output(q.operand(x) @ q.operand(w).t()) + P[key + ".bias"]


def head(P, arch, pooled, q: Quant = None):
    """(N, P, P, C) pooled RoIs -> class scores (N, K), deltas (N, E*K): layer4
    at stride 1, the spatial mean, the two predictors."""
    x = _stage_fwd(pooled.permute(0, 3, 1, 2), P, arch, "layer4", q, caffe=False)
    fc7 = x.mean(dim=(2, 3))
    return (_linear(fc7, P, "predictors.cls_score_net", q),
            _linear(fc7, P, "predictors.bbox_pred_net", q))


# -- the detector around it -----------------------------------------------------------


class Draws(NamedTuple):
    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


class Detector:
    """Configuration, anchors and the two passes of the reference detector."""

    def __init__(self, cfg: Dict[str, object], num_classes: int, device):
        self.cfg, self.k, self.device = cfg, num_classes, torch.device(device)
        self.arch = architecture(cfg, num_classes)
        self.lidar = cfg["NET_TYPE"] == "lidar"
        self.elem = 7 if self.lidar else 4
        self._grids: Dict[tuple, tuple] = {}

    # shapes
    def feature_hw(self, hw):
        return -(-hw[0] // 16), -(-hw[1] // 16)

    def lanes(self, hw) -> Tuple[int, int]:
        """(anchors, proposals) a training frame: the sizes of the step's keys."""
        fh, fw = self.feature_hw(hw)
        n = fh * fw * self.arch.anchors
        c = self.cfg
        return n, min(c["STATIC.NMS_PRE_TRAIN"], c["TRAIN.RPN_PRE_NMS_TOP_N"], n,
                      c["TRAIN.RPN_POST_NMS_TOP_N"])

    def grid(self, fh, fw, phase):
        """(BEV anchors (N, 4), 3D anchors (N, 7) or None) for a map and phase."""
        c = self.cfg
        scale = float(c[f"{phase}.SCALES"][0])
        key = (fh, fw, scale)
        if key not in self._grids:
            if self.lidar:
                bev, a3 = ops.anchors_3d(fh, fw, 16, c["LIDAR.ANCHORS"], c["LIDAR.ANCHOR_ANGLES"],
                                         c["LIDAR.VOXEL_LEN"], scale)
                self._grids[key] = (torch.from_numpy(bev).to(self.device),
                                    torch.from_numpy(a3).to(self.device))
            else:
                bev = ops.anchors_2d(fh, fw, 16, c["ANCHOR_SCALES"], c["ANCHOR_RATIOS"], scale)
                self._grids[key] = (torch.from_numpy(bev).to(self.device), None)
        return self._grids[key]

    def raster_grid(self) -> dict:
        """The voxelizer's grid at TRAIN.SCALES[0] (the loader rasterizes at it
        in both phases)."""
        c = self.cfg
        vl = c["LIDAR.VOXEL_LEN"] / float(c["TRAIN.SCALES"][0])
        xr, yr = c["LIDAR.X_RANGE"], c["LIDAR.Y_RANGE"]
        return dict(x_range=xr, y_range=yr, z_range=c["LIDAR.Z_RANGE"],
                    voxel_height=c["LIDAR.VOXEL_HEIGHT"], num_x=int((xr[1] - xr[0]) / vl),
                    num_y=int((yr[1] - yr[0]) / vl), num_slices=c["LIDAR.NUM_SLICES"],
                    num_meta=c["LIDAR.NUM_META_CHANNEL"], max_pts=c["LIDAR.MAX_PTS_PER_VOXEL"])

    def inputs(self, data):
        """Frames (uint8 NHWC) or rasters (float NHWC) -> NCHW float32."""
        if not data.is_floating_point():
            means = torch.tensor(self.cfg["PIXEL_MEANS"], device=data.device)
            stds = torch.tensor(self.cfg["PIXEL_STDDEVS"], device=data.device)
            data = (data.float() - means) / stds
        return data.float().permute(0, 3, 1, 2)

    def draws(self, gen: torch.Generator, b: int, hw) -> Draws:
        """A step's keys, drawn in the port's order (anchor fg, bg; roi fg, bg)."""
        n, r = self.lanes(hw)
        kw = dict(generator=gen, device=self.device)
        return Draws(torch.rand((b, n), **kw), torch.rand((b, n), **kw),
                     torch.rand((b, r), **kw), torch.rand((b, r), **kw))

    def proposals(self, fg, deltas, anchors, window, phase) -> Dict[str, torch.Tensor]:
        """What the proposal layer sees (fg scores, deltas, window) and chooses
        (rois, scores, valid, src), detached."""
        rois, scores, valid, src = self.propose(fg, deltas, anchors, window, phase)
        return {"fg": fg.detach(), "deltas": deltas.detach(), "window": window, "rois": rois,
                "scores": scores, "valid": valid, "src": src}

    def propose(self, fg, deltas, anchors, window, phase):
        """Top min(STATIC.NMS_PRE_*, RPN_PRE_NMS_TOP_N) scores -> NMS at
        RPN_NMS_THRESH -> RPN_POST_NMS_TOP_N lanes: (rois, scores, valid, src)."""
        c = self.cfg
        pre = min(c["STATIC.NMS_PRE_TRAIN" if phase == "TRAIN" else "STATIC.NMS_PRE_TEST"],
                  c[f"{phase}.RPN_PRE_NMS_TOP_N"])
        boxes = ops.clip_boxes(ops.bbox_transform_inv(anchors, deltas), window)
        ss, order = torch.sort(fg, dim=1, descending=True, stable=True)
        k = min(pre, fg.shape[1])
        top, order = ss[:, :k], order[:, :k]
        tb = ops.gather_lanes(boxes, order)
        keep, ok = ops.nms(tb, top, c[f"{phase}.RPN_NMS_THRESH"], c[f"{phase}.RPN_POST_NMS_TOP_N"])
        scores = torch.where(ok, ops.gather_lanes(top, keep), 0.0)
        return ops.gather_lanes(tb, keep), scores, ok, ops.gather_lanes(order, keep)

    # -- training ------------------------------------------------------------------
    def anchor_targets(self, anchors, gt, gt_mask, window, d: Draws):
        c = self.cfg
        pos, neg = c["TRAIN.RPN_POSITIVE_OVERLAP"], c["TRAIN.RPN_NEGATIVE_OVERLAP"]
        if self.lidar:
            pos = c["LIDAR.RPN_POSITIVE_OVERLAP"] if c["LIDAR.RPN_POSITIVE_OVERLAP"] > 0 else pos
            neg = c["LIDAR.RPN_NEGATIVE_OVERLAP"] if c["LIDAR.RPN_NEGATIVE_OVERLAP"] > 0 else neg
        return ops.anchor_target(anchors, self.gt_bev(gt), gt_mask, window, d.anchor_fg,
                                 d.anchor_bg, batch=c["TRAIN.RPN_BATCHSIZE"],
                                 fg_fraction=c["TRAIN.RPN_FG_FRACTION"], pos=pos, neg=neg)

    def gt_bev(self, gt):
        if not self.lidar:
            return gt
        return torch.cat([ops.bev_envelope(gt[..., :7]), gt[..., 7:8]], -1)

    def train_losses(self, P, batch, d: Draws, pinned=None, q: Quant = None, denominators=None):
        """The four losses of a batch (frames, gt_boxes, gt_mask, window) and
        what the proposal layer saw and chose (`proposals`).  `pinned` (a
        proposals dict: lanes `src`, `valid` and their boxes `rois`) makes the
        second stage follow another run's proposals and sample its RoIs by the
        IoUs of those boxes.  `denominators` (from `denoms` on the whole batch)
        lets a chunk of frames give its share of the whole batch's losses."""
        c = self.cfg
        data, gt, gt_mask, window = batch
        b = gt.shape[0]
        feat = backbone(P, self.arch, self.inputs(data), q)
        logits, fg, deltas = rpn(P, self.arch, feat, q)
        anchors, a3 = self.grid(feat.shape[2], feat.shape[3], "TRAIN")
        at = self.anchor_targets(anchors, gt, gt_mask, window, d)
        den = denominators or self.denoms(at, b)
        active = (at.labels >= 0).float().reshape(-1)
        nll = -torch.log_softmax(ops.gather_lanes(logits, at.sel).reshape(-1, 2), -1).gather(
            -1, at.labels.clamp(min=0).long().reshape(-1, 1))[:, 0]
        losses = {"rpn_cross_entropy": (nll * active).sum() / den["rpn_active"],
                  "rpn_loss_box": (at.outside * ops.huber(
                      ops.gather_lanes(deltas, at.sel) * at.inside - at.targets * at.inside)
                  ).sum() / den["frames"]}
        with torch.no_grad():
            proposals = self.proposals(fg, deltas, anchors, window, "TRAIN")
        used = proposals if pinned is None else pinned
        src, valid = used["src"], used["valid"]
        rois = ops.clip_boxes(ops.bbox_transform_inv(anchors[src], ops.gather_lanes(deltas, src)),
                              window)
        lidar = self.lidar
        means = torch.tensor(c["TRAIN.LIDAR.BBOX_NORMALIZE_MEANS" if lidar else
                               "TRAIN.IMAGE.BBOX_NORMALIZE_MEANS"], device=rois.device)
        stds = torch.tensor(c["TRAIN.LIDAR.BBOX_NORMALIZE_STDS" if lidar else
                              "TRAIN.IMAGE.BBOX_NORMALIZE_STDS"], device=rois.device)
        pt = ops.proposal_target(
            rois, valid, self.gt_bev(gt), gt_mask, d.roi_fg, d.roi_bg, means, stds,
            sample_boxes=used["rois"],
            num_classes=self.k, elem=self.elem, batch=c["TRAIN.ROI_BATCH_SIZE"],
            fg_fraction=c["TRAIN.FG_FRACTION"], fg_thresh=c["TRAIN.FG_THRESH"],
            bg_hi=c["TRAIN.BG_THRESH_HI"], bg_lo=c["TRAIN.BG_THRESH_LO"],
            anchors3d=a3[src] if lidar else None, gt7=gt if lidar else None)
        s = pt.labels.shape[1]
        pooled = ops.roi_align(feat.permute(0, 2, 3, 1), pt.rois, 1.0 / 16,
                               c["POOLING_SIZE"]).reshape((b * s,) + (c["POOLING_SIZE"],) * 2
                                                          + (feat.shape[1],))
        score, box = head(P, self.arch, pooled, q)
        nll2 = -torch.log_softmax(score, -1).gather(-1, pt.labels.reshape(-1, 1))[:, 0]
        losses["cross_entropy"] = nll2.sum() / den["rois"]
        d7 = (box.reshape(b, s, -1) * pt.inside - pt.targets * pt.inside)
        if lidar:
            d7 = d7.reshape(-1, 7)
            heading = torch.sin(d7[:, 6:]) if c["LIDAR.EN_RY_SIN"] else d7[:, 6:]
            el = ops.huber(torch.cat([d7[:, :6], heading], 1)) * torch.tensor(
                c["LIDAR.REG_LOSS_WEIGHT"], device=d7.device)
            el = el.reshape(b, s, -1)
        else:
            el = ops.huber(d7)
        losses["loss_box"] = (pt.outside * el).sum() / den["rois"]
        losses["total_loss"] = (losses["rpn_cross_entropy"] + losses["rpn_loss_box"]
                                + losses["cross_entropy"] + losses["loss_box"])
        return losses, proposals

    def denoms(self, at, b) -> Dict[str, torch.Tensor]:
        """The whole batch's loss denominators: active RPN lanes, frames, RoIs."""
        return {"rpn_active": torch.clamp((at.labels >= 0).float().sum(), min=1.0),
                "frames": float(b), "rois": float(b * self.cfg["TRAIN.ROI_BATCH_SIZE"])}

    # -- serving -------------------------------------------------------------------
    def serve(self, P, data, window, q: Quant = None, rois=None, anchors_3d=None):
        """A serving pass: the proposal layer's rois, roi_scores, roi_valid
        (anchors_3d for LiDAR) and what it saw and chose (`proposals`), and
        cls_prob, bbox_pred of the second stage over `rois` (the proposal
        layer's own when None)."""
        c = self.cfg
        feat = backbone(P, self.arch, self.inputs(data), q)
        _, fg, deltas = rpn(P, self.arch, feat, q)
        anchors, a3 = self.grid(feat.shape[2], feat.shape[3], "TEST")
        prop = self.proposals(fg, deltas, anchors, window, "TEST")
        own = (prop["rois"], prop["scores"], prop["valid"], prop["src"])
        out = {"rois": own[0], "roi_scores": own[1], "roi_valid": own[2], "proposals": prop}
        if self.lidar:
            out["anchors_3d"] = a3[own[3]]
        r = own[0] if rois is None else rois
        r3 = out.get("anchors_3d") if anchors_3d is None else anchors_3d
        b, s = r.shape[:2]
        p = c["POOLING_SIZE"]
        pooled = ops.roi_align(feat.permute(0, 2, 3, 1), r, 1.0 / 16, p)
        score, box = head(P, self.arch, pooled.reshape(b * s, p, p, -1), q)
        lidar = self.lidar
        means = torch.tensor(c["TRAIN.LIDAR.BBOX_NORMALIZE_MEANS" if lidar else
                               "TRAIN.IMAGE.BBOX_NORMALIZE_MEANS"], device=r.device)
        stds = torch.tensor(c["TRAIN.LIDAR.BBOX_NORMALIZE_STDS" if lidar else
                              "TRAIN.IMAGE.BBOX_NORMALIZE_STDS"], device=r.device)
        deltas2 = (box.reshape(b, s, self.k, self.elem) * stds + means).reshape(b, s, -1)
        out["cls_prob"] = torch.softmax(score.reshape(b, s, -1), -1)
        out["bbox_pred"] = (ops.lidar_transform_inv(r, r3, deltas2) if lidar else
                            ops.clip_boxes(ops.bbox_transform_inv(r, deltas2), window))
        return out

    def filter(self, out):
        c = self.cfg
        return ops.filter_detections(
            out["cls_prob"], out["bbox_pred"], out["roi_valid"], elem=self.elem,
            max_dets=c["TEST.MAX_DETS"], thresh=c["TEST.THRESH"], nms_thresh=c["TEST.NMS_THRESH"],
            lidar=self.lidar, rotated=c["TEST.ROTATED_NMS"])


# -- the optimizer --------------------------------------------------------------------


class SGD:
    """Global-norm clip (GRAD_MAX_CLIP), weight decay on weights (biases too
    with BIAS_DECAY), 2x learning rate on biases with DOUBLE_BIAS, SGD
    momentum at TRAIN.LEARNING_RATE (the first update is step 0 of the
    schedule)."""

    def __init__(self, cfg, arch: Arch, P: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.keys = [s.key for s in arch.specs if s.trainable]
        self.buf: Dict[str, torch.Tensor] = {}
        self.count = 0
        for k, v in P.items():
            v.requires_grad_(k in self.keys)

    def lr(self) -> float:
        c = self.cfg
        v = np.float32(c["TRAIN.LEARNING_RATE"])
        for boundary in sorted(set(int(s) for s in c["TRAIN.STEPSIZE"])):
            if self.count >= boundary:
                v = np.float32(np.float32(c["TRAIN.GAMMA"]) * v)
        return float(v)

    def step(self, P) -> Dict[str, torch.Tensor]:
        """One update from P's .grad; returns each leaf's clipped gradient."""
        c = self.cfg
        grads = {k: (P[k].grad if P[k].grad is not None else torch.zeros_like(P[k]))
                 for k in self.keys}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = c["GRAD_MAX_CLIP"] / torch.clamp(norm, min=c["GRAD_MAX_CLIP"])
        if not torch.isfinite(norm):
            scale = torch.zeros(())
        lr = self.lr()
        with torch.no_grad():
            for k in self.keys:
                g = grads[k] * scale
                grads[k] = g
                bias = k.endswith(".bias")
                decay = c["TRAIN.BIAS_DECAY"] or not bias
                d = g + c["TRAIN.WEIGHT_DECAY"] * P[k] if decay else g
                self.buf[k] = d if k not in self.buf else c["TRAIN.MOMENTUM"] * self.buf[k] + d
                P[k] -= lr * (2.0 if bias and c["TRAIN.DOUBLE_BIAS"] else 1.0) * self.buf[k]
                P[k].grad = None
        self.count += 1
        return grads
