"""Device-time stopwatch for the serving and training loops, and the port's
tracing spans.

`span(name)` marks a stretch of the port's host code.  With no torch
profiler running it is one shared no-op context.  Under a running profiler
it enters `torch.profiler.record_function(name)`, so the span lands in the
profiler's trace beside the kernels, and keeps one record in memory:
(name, parent, thread, start_ns, end_ns, root), stamped with
`time.time_ns()`, the clock the profiler stamps its events with.  `parent`
is the index in `spans()` of the enclosing span on the same thread, `root`
the index of the outermost one (one training step or served batch shares
it).  A span named `sync.<site>` marks a place where the host waits for the
device.  Nothing is written to disk: `spans()` returns the records and
`reset_spans()` clears them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, NamedTuple, Optional

import torch

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_RECORDS: List[list] = []  # [name, parent, thread, start_ns, end_ns, root]
_LOCAL = threading.local()


class Span(NamedTuple):
    name: str
    parent: Optional[int]  # index in spans() of the enclosing span, same thread
    thread: int  # threading.get_ident() of the thread that ran it
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: Optional[int]  # None while the span is open
    root: int  # index in spans() of the outermost enclosing span (itself for a root)


class _Recorded:
    __slots__ = ("name", "fn", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack = _LOCAL.__dict__.setdefault("stack", [])
        with _LOCK:
            index = len(_RECORDS)
            parent, root = (stack[-1][0], stack[-1][1][5]) if stack else (None, index)
            self.rec = [self.name, parent, threading.get_ident(), time.time_ns(), None, root]
            _RECORDS.append(self.rec)
        stack.append((index, self.rec))
        return self

    def __exit__(self, *exc) -> None:
        self.rec[4] = time.time_ns()
        _LOCAL.stack.pop()
        self.fn.__exit__(*exc)


def span(name: str):
    """A context over a stretch of host code: a no-op unless a torch
    profiler is running (see the module docstring)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recorded(name)


def spans() -> List[Span]:
    """The spans recorded since the last reset_spans(), in the order they
    were entered."""
    with _LOCK:
        return [Span(*r) for r in _RECORDS]


def reset_spans() -> None:
    """Forget the recorded spans; call it while no span is open."""
    with _LOCK:
        _RECORDS.clear()


class DeviceTimer:
    """Milliseconds of the work issued between start() and stop(): CUDA
    events on a CUDA device, the host clock otherwise."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        with span("sync.timer"):
            if self.cuda:
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record()
                t1.synchronize()
                return self._t0.elapsed_time(t1)
            return (time.perf_counter() - self._t0) * 1e3
