"""Device-time stopwatch for the serving and training loops."""

from __future__ import annotations

import time

import torch


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
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self._t0.elapsed_time(t1)
        return (time.perf_counter() - self._t0) * 1e3
