"""Training metrics: the Solver's logs.

A copy of faster_rcnn_pytorch_multimodal_tpu/training/metrics.py:20-60:
  * an always-on JSONL scalar log, `scalars.jsonl`, one record a call with
    the JAX package's layout (`step`, `time`, then the scalars);
  * TensorBoard event files through torch.utils.tensorboard, where it
    imports, with the same scalar tags;
  * `image` saves a PNG beside the log (utils.visualization.save_image).
The console lines ("iter: i / N, total loss", "speed: s / iter") stay in
the Solver.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, suffix: str = ""):
        self.log_dir = log_dir + (f"_{suffix}" if suffix else "")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.log_dir)
        except Exception:
            pass

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def image(self, step: int, tag: str, image, save_png: bool = True) -> None:
        """HWC uint8 image -> TensorBoard, and a PNG beside the log unless
        the caller saved the frame elsewhere (save_png False)."""
        if self._tb is not None:
            self._tb.add_image(tag, image, int(step), dataformats="HWC")
        if save_png:
            from faster_rcnn_pytorch_multimodal_tpu_torch.utils.visualization import save_image

            save_image(image, os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png"))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """MetricsWriter's calls, writing nothing: a data-parallel rank other
    than 0 (rank 0 logs the global scalars)."""

    def __init__(self, *_args, **_kwargs):
        pass

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        pass

    def image(self, step: int, tag: str, image, save_png: bool = True) -> None:
        pass

    def close(self) -> None:
        pass
