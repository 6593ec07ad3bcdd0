"""Reading a torch.profiler trace of a stretch of the window: the device's
busy time (the union of every device operation's interval, so overlapping
streams count once), the operations that took most time, the idle gaps
labelled by what the host was doing, and the launch calls.

The pattern is the port's `tools/profile_step_torch.py` (`_device_work`:
the profiler's CUDA events and their ranges), with the busy share taken
over the whole profiled stretch, not the span from the first kernel to the
last.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10
SPAN_PREFIX = "portbench."  # the harness's record_function spans
WINDOW = SPAN_PREFIX + "window"  # the span over the whole profiled stretch


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events, window_us: Tuple[float, float]) -> Dict:
    """events: prof.events() of the stretch; window_us: its (start, end) on the
    profiler's clock.  Returns busy and window seconds, seconds by device
    operation, idle seconds by host activity, launch calls and kernel times."""
    device, host, spans = [], [], []
    for e in events:
        tr = e.time_range
        if e.device_type.name == "CUDA":
            if not (e.is_user_annotation or e.name.startswith(SPAN_PREFIX)):
                device.append((tr.start, tr.end, e.name))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    w0, w1 = window_us
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device if min(e, w1) > max(s, w0)])
    busy_us = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_op[name] += (e - s) / 1e6
    # idle gaps between busy stretches, labelled by the innermost host event at their midpoint
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for seg in busy for x in seg] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        label, best = None, None
        for s, e, name in reversed(host[max(0, i - 64):i]):
            if e >= mid and (best is None or e - s < best):
                label, best = name, e - s
        if label is None:  # no op of the host's: the harness's span that holds it
            label = next((name for s, e, name in spans if s <= mid <= e and name != WINDOW),
                         "python between ops")
        gaps[label] += (b - a) / 1e6
    launches = sum(1 for _, _, name in host if name in LAUNCH_CALLS)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
        "launches": launches,
        "kernels": [(name, (e - s) / 1e6) for s, e, name in device],
    }


def kernel_seconds(summary: Dict, match) -> Tuple[float, int]:
    """Total device seconds and count of the operations whose name `match`
    accepts."""
    hits = [t for name, t in summary["kernels"] if match(name)]
    return sum(hits), len(hits)
