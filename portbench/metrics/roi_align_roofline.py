"""The single-level RoI align kernels' share of their roofline: the least
time of the profiled launches (portbench.yardstick.roi_align_bound_ms at the
cell's shapes: forward, and in training the feature gradient) over the
device time of `roi_align_fwd_kernel` (and `roi_bucket_kernel` +
`roi_align_bwd_kernel`) in the trace; left out on a card other than the
H100 SXM whose peaks portbench.yardstick holds."""

from portbench import trace, yardstick


def _is(*parts):
    return lambda name: any(p in name for p in parts) and "_ms_" not in name


def read(ctx):
    rcfg, s, train = ctx["rcfg"], ctx["trace"], ctx["cell"].traffic["path"] == "train"
    fwd_s, n = trace.kernel_seconds(s, _is("roi_align_fwd"))
    if not n or not yardstick.on_card(ctx["kind"]):
        return None
    device_s = fwd_s + (trace.kernel_seconds(s, _is("roi_align_bwd", "roi_bucket"))[0]
                        if train else 0.0)
    b = ctx["cell"].traffic["batch"]
    rois = rcfg["TRAIN.ROI_BATCH_SIZE"] if train else rcfg["TEST.RPN_POST_NMS_TOP_N"]
    fh, fw = yardstick.c4_hw(ctx["hw"])
    item = 2 if rcfg["COMPUTE_DTYPE"] == "bfloat16" else 4
    args = (b, fh, fw, ctx["arch"].c4, rois, rcfg["POOLING_SIZE"], item)
    bound_ms = yardstick.roi_align_bound_ms(*args) * (2 if train else 1)
    return 100.0 * n * bound_ms / 1e3 / device_s
