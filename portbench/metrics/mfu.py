"""Model FLOPs a frame (portbench.yardstick.model_flops, from the
configuration's shapes: forward, and in training the backward of what
trains) times the run's frames a second, over the H100 SXM's bf16 dense
peak (left out on another card)."""

from portbench import yardstick


def read(ctx):
    if not yardstick.on_card(ctx["kind"]):
        return None
    rcfg, train = ctx["rcfg"], ctx["cell"].traffic["path"] == "train"
    rois = rcfg["TRAIN.ROI_BATCH_SIZE"] if train else rcfg["TEST.RPN_POST_NMS_TOP_N"]
    flops = yardstick.model_flops(ctx["arch"], ctx["hw"], rois, rcfg["POOLING_SIZE"], train)
    return 100.0 * flops * ctx["frames_per_s"] / yardstick.BF16_FLOPS
