"""The share of the profiled stretch in which no operation ran on the device
(100 minus the union of the device operations' intervals over the stretch)."""


def read(ctx):
    s = ctx["trace"]
    if not s["window_s"] or not s["kernels"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
