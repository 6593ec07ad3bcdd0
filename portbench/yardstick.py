"""The benchmark's frozen arithmetic: the card's published peaks, the least
time a kernel could take, RoI align's bytes and operations, and the
detector's model FLOPs counted from the configuration's shapes alone.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
the full 700 W).  `bound_ms` and the RoI-align operation count are copied
from the port's `chip_smoke.bound_ms` and `chip_smoke.roi_align_flops`; the
bytes follow the port's PERF.md section 6 rule: each input byte read once,
each output byte written once.
"""

from __future__ import annotations

from typing import Tuple

CARD = "NVIDIA H100 80GB HBM3"  # the card these peaks are for, as torch.cuda names it
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


def on_card(kind: str) -> bool:
    """Whether a run's card is the one whose peaks these are; a share of a
    peak or a roofline read on another card is left out of the result."""
    return kind == CARD


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_align_flops(n_out: int, sr: int = 2) -> int:
    """float32 operations of RoI align per output (or dOut) element: sr x sr
    samples of 4 bilinear taps, a multiply and an add each."""
    return n_out * sr * sr * 4 * 2


def roi_align_bound_ms(b: int, fh: int, fw: int, c: int, rois: int, p: int,
                       itemsize: int) -> float:
    """The least time of one single-level RoI align over B frames' (fh, fw, c)
    maps and `rois` RoIs a frame: the map and the pooled output each moved
    once.  Its feature gradient moves the same bytes (the pooled gradient in,
    the map's out) and does the same operations."""
    n_out = b * rois * p * p * c
    nbytes = (b * fh * fw * c + n_out) * itemsize
    return bound_ms(nbytes, roi_align_flops(n_out))[0]


# -- model FLOPs ---------------------------------------------------------------------


def _out(n: int, k: int, s: int, pad: int) -> int:
    return (n + 2 * pad - k) // s + 1


def conv_layers(arch, in_hw: Tuple[int, int], rois: int, p: int):
    """(name, MACs, trains, input needs a gradient) of every convolution and
    dense layer of a C4 detector at frames of in_hw with `rois` RoIs a frame,
    per frame.  `arch` is reference.model.Arch."""
    specs = {s.key: s for s in arch.specs}
    h, w = in_hw
    out = []

    def conv(key, h, w, stride, pad, times=1, grad_in=True):
        cout, cin, k, _ = specs[key + ".weight"].shape
        oh, ow = _out(h, k, stride, pad), _out(w, k, stride, pad)
        out.append((key, cout * cin * k * k * oh * ow * times, specs[key + ".weight"].trainable,
                    grad_in))
        return oh, ow

    h, w = conv("backbone.conv1", h, w, 2, 3, grad_in=False)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    grad_in = False  # nothing before the first trainable layer needs a gradient

    def stage(name, h, w, caffe, times, grad_in):
        for k, _cin, s, ds in arch.plans[name]:
            trains = specs[k + ".conv1.weight"].trainable
            gi = grad_in
            if ds:
                conv(k + ".downsample.0", h, w, s, 0, times, gi)
            if arch.basic:
                h1, w1 = conv(k + ".conv1", h, w, s, 1, times, gi)
                conv(k + ".conv2", h1, w1, 1, 1, times, trains or gi)
            else:
                s1, s2 = (s, 1) if caffe else (1, s)
                h1, w1 = conv(k + ".conv1", h, w, s1, 0, times, gi)
                h1, w1 = conv(k + ".conv2", h1, w1, s2, 1, times, trains or gi)
                conv(k + ".conv3", h1, w1, 1, 0, times, trains or gi)
            h, w = _out(h, 1, s, 0), _out(w, 1, s, 0)
            grad_in = grad_in or trains
        return h, w, grad_in

    h, w, grad_in = stage("layer1", h, w, False, 1, grad_in)
    h, w, grad_in = stage("layer2", h, w, True, 1, grad_in)
    fh, fw, grad_in = stage("layer3", h, w, True, 1, grad_in)
    conv("rpn.rpn_net", fh, fw, 1, 1, grad_in=grad_in)
    conv("rpn.rpn_cls_score_net", fh, fw, 1, 0)
    conv("rpn.rpn_bbox_pred_net", fh, fw, 1, 0)
    stage("layer4", p, p, False, rois, True)
    for key in ("predictors.cls_score_net", "predictors.bbox_pred_net"):
        cout, cin = specs[key + ".weight"].shape
        out.append((key, cout * cin * rois, True, True))
    return out


def model_flops(arch, in_hw: Tuple[int, int], rois: int, p: int, train: bool) -> int:
    """Model FLOPs a frame: 2 per multiply-add of every convolution and dense
    layer forward; in training also the backward of what trains, the weight
    gradient of each trainable layer and the input gradient wherever
    something before it trains.  Frozen stages run forward only."""
    total = 0
    for _key, macs, trains, grad_in in conv_layers(arch, in_hw, rois, p):
        total += 2 * macs
        if train:
            total += 2 * macs * (int(trains) + int(grad_in))
    return total


def c4_hw(in_hw) -> Tuple[int, int]:
    """The stride-16 map of frames of in_hw."""
    return -(-in_hw[0] // 16), -(-in_hw[1] // 16)
