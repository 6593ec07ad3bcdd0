"""Launch calls (kernel or graph launches through the CUDA runtime or
driver) in the profiled stretch, over the frames it served or trained."""


def read(ctx):
    n = ctx["trace"]["launches"]
    return n / ctx["frames"] if n and ctx["frames"] else None
