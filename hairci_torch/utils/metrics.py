"""Metric logging (port of ``hairci/utils/metrics.py``, the reference's
``misc.py:29-173``, MAE lineage): ``SmoothedValue`` (a windowed and a global
average), ``MetricLogger``, and the label-smoothing cross-entropy
(``misc.py:539+``).

``synchronize_between_processes`` sums (count, total) over the processes
with ``torch.distributed`` when a process group is initialised, and
otherwise returns, as the JAX package does with one process.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


class SmoothedValue:
    """Windowed + global average tracker."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def synchronize_between_processes(self) -> None:
        """The sum of (count, total) over the processes (f64, on the CPU:
        the gloo and NCCL groups alike take it through
        ``all_gather_object``)."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() == 1:
            return
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (self.count, self.total))
        self.count = int(sum(c for c, _ in parts))
        self.total = float(np.sum([t for _, t in parts], dtype=np.float64))

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            if i % print_freq == 0:
                elapsed = time.time() - start
                print(f"{header} [{i}]  {self}  ({elapsed:.1f}s)")


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """mean((1 - smoothing) * nll + smoothing * mean(-log p)): the
    reference's ``LabelSmoothingCrossEntropy``."""
    logprobs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, labels[..., None].long())[..., 0]
    smooth = -logprobs.mean(dim=-1)
    return torch.mean((1.0 - smoothing) * nll + smoothing * smooth)
