"""Metrics logging: structured stdout lines and TensorBoard scalars (port of
``recmodels_tpu/utils/logging.py``). The trainer fetches each metric from
the device once a log interval; nothing here syncs per step.

TensorBoard goes through ``torch.utils.tensorboard``; where that package is
missing, one text line says so and the scalars go to stdout only."""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, tb_dir: str | None = None, stream=None):
        self.stream = stream or sys.stdout
        self._writer = None
        self._t0 = time.time()
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.log_text("torch.utils.tensorboard unavailable (no tensorboard package); "
                              "TB logging disabled")
            else:
                self._writer = SummaryWriter(tb_dir)

    def log_text(self, msg: str):
        print(f"[{time.time() - self._t0:8.1f}s] {msg}", file=self.stream, flush=True)

    def log_scalars(self, step: int, scalars: dict, prefix: str = "train"):
        if self._writer is not None:
            for k, v in scalars.items():
                self._writer.add_scalar(f"{prefix}/{k}", float(v), step)
        payload = {k: round(float(v), 6) for k, v in scalars.items()}
        self.log_text(f"step {step:>8d} {prefix} {json.dumps(payload)}")

    def close(self):
        if self._writer is not None:
            self._writer.close()
