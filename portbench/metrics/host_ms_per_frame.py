"""The host's milliseconds a frame in the profiled stretch, read from the
port's own spans (`utils.timer.spans()`, recorded only while the profiler
runs): the time the main thread spent inside the port's root spans (a
training step, a served batch's detect and filter calls, a raster made
outside them), less the time inside their `sync.*` spans, where the host
waits for the device, over the frames profiled.  Nothing where the port
records no span."""

import threading


def host_ms(records, thread: int):
    """Milliseconds of `thread` inside its closed root spans, less their
    outermost sync.* spans, or None without a root; records:
    utils.timer.spans() (parents and roots by index)."""
    def synced(i):  # whether span i or an enclosing span is a sync
        while i is not None:
            if records[i].name.startswith("sync."):
                return True
            i = records[i].parent
        return False

    ns, roots = 0, 0
    for r in records:
        if r.thread != thread or records[r.root].end_ns is None:
            continue
        if r.parent is None:
            ns += r.end_ns - r.start_ns
            roots += 1
        if r.name.startswith("sync.") and not synced(r.parent):
            ns -= r.end_ns - r.start_ns
    return ns / 1e6 if roots else None


def read(ctx):
    try:
        from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import spans
    except ImportError:  # a port without spans
        return None
    ms = host_ms(spans(), threading.main_thread().ident)
    return ms / ctx["frames"] if ms is not None and ctx["frames"] else None
