"""Profiling helpers (port of ``hairci/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the host and, where
a card is present, of CUDA, and writes it to ``log_dir/trace.json`` (Chrome
trace format; open it in Perfetto or ``chrome://tracing``). ``annotate(name)``
names a region of that timeline (``record_function``). ``StepTimer`` times
steps on the host clock and discards the first ``warmup``; given a CUDA
device it synchronises the card as a step starts and ends, so a step's time
includes the work it queued there.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, List, Optional

import torch

from hairci_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace lands in ``log_dir/trace.json``. Yields
    the profiler (``key_averages()`` for a table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-clock per-step timing with warmup discard."""

    def __init__(self, warmup: int = 2, device: DeviceLike = None):
        self.warmup = warmup
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._step = 0

    def _sync(self) -> None:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._step += 1
        if self._step > self.warmup:
            self._times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def p50(self) -> float:
        if not self._times:
            return 0.0
        s = sorted(self._times)
        return s[len(s) // 2]
