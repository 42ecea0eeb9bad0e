"""TensorBoard + JSONL metric logging for training: a copy of
`MetricLogger` from `propainter_tpu/utils/tb.py`, pinned to it by source
(tests/test_torch_train.py). Windowed scalar means written to
`metrics.jsonl`, and to TensorBoard where `torch.utils.tensorboard` imports.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    """Windowed scalar averaging + TensorBoard/JSONL sinks.

    Reference core/trainer.py:197-205 accumulates each scalar in a dict and
    writes the mean every `log_freq` calls; we do the same.
    """

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._acc: dict[str, float] = {}
        self._n: dict[str, int] = {}
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add(self, name: str, value: float):
        self._acc[name] = self._acc.get(name, 0.0) + float(value)
        self._n[name] = self._n.get(name, 0) + 1

    def flush_scalars(self, step: int):
        out = {}
        for name, total in self._acc.items():
            mean = total / max(1, self._n[name])
            out[name] = mean
            if self._tb is not None:
                self._tb.add_scalar(name, mean, step)
        self._acc.clear()
        self._n.clear()
        self._jsonl.write(json.dumps(
            {"step": step, "time": time.time(), **out}) + "\n")
        self._jsonl.flush()
        return out

    def add_images(self, name: str, images: np.ndarray, step: int):
        """images: (N, H, W, 3) float in [0,1] or uint8. Writes a grid
        (reference trainer.py:449-478 uses make_grid; we tile horizontally)."""
        if self._tb is None:
            return
        imgs = np.asarray(images)
        if imgs.dtype != np.uint8:
            imgs = (np.clip(imgs, 0.0, 1.0) * 255).astype(np.uint8)
        grid = np.concatenate(list(imgs), axis=1)  # tile along width
        self._tb.add_image(name, grid, step, dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
