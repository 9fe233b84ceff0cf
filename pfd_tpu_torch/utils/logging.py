"""Logging / metrics (the port of ``pfd_tpu/utils/logging.py``).

Reference (lib/log_service.py): ``print_log`` gated to rank 0 with a
train.log append; ``distributed_log_manager`` accumulates weighted loss
dicts, all-reduces means over DDP and writes tensorboardX scalars. The port
runs one process per trainer, so what remains is accumulation, rank-0
gating (``torch.distributed``'s rank where a group is initialised) and the
file sinks: ``metrics.jsonl``, and tensorboardX where it can be imported.
"""

from __future__ import annotations

import json
import os
import time

import torch


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def print_log(*console_info, log_file=None):
    """Rank-0 console print + optional append to train.log
    (log_service.py:13-35 semantics)."""
    if _rank() != 0:
        return
    msg = " ".join(str(i) for i in console_info)
    print(msg)
    if log_file is not None:
        with open(log_file, "a") as f:
            f.write(msg + "\n")


class MetricLogger:
    """Weighted metric accumulation + periodic flush to JSONL (and
    tensorboardX when importable) — log_service.py:37-139 equivalent."""

    def __init__(self, log_dir=None, use_tensorboard=True):
        self.log_dir = log_dir
        self._sums: dict[str, float] = {}
        self._weights: dict[str, float] = {}
        self.time_ref = time.time()
        self._tb = None
        if log_dir is not None and _rank() == 0:
            os.makedirs(log_dir, exist_ok=True)
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
                except ImportError:
                    self._tb = None

    def accumulate(self, metrics: dict, weight: float = 1.0):
        """Add each metric (a number or a 0-d tensor, read on the host)."""
        for k, v in metrics.items():
            v = float(v)
            self._sums[k] = self._sums.get(k, 0.0) + v * weight
            self._weights[k] = self._weights.get(k, 0.0) + weight

    def means(self) -> dict:
        return {k: self._sums[k] / max(self._weights[k], 1e-12) for k in self._sums}

    def clear(self):
        self._sums.clear()
        self._weights.clear()

    def tick(self, step: int, extra: dict | None = None) -> dict:
        """Flush accumulated means at `step`; returns what was logged."""
        record = {"step": int(step), "time": time.time() - self.time_ref,
                  **self.means(), **(extra or {})}
        if _rank() == 0 and self.log_dir is not None:
            with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
            if self._tb is not None:
                for k, v in record.items():
                    if isinstance(v, (int, float)) and k != "step":
                        self._tb.add_scalar(f"loss/{k}", v, step)
        self.clear()
        return record
