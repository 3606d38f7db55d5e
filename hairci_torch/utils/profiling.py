"""Profiling helpers (port of ``hairci/utils/profiling.py``), and the port's
spans.

``span(name, items, device)`` names a region of the port's hot path: the
phases of ``SHAMRecipe.train_step`` (``sham.step``, ``sham.augment``,
``sham.forward``, ``sham.backward``, ``sham.update``), the copies and the
forward of ``_EncoderBase.extract_features`` (``embed.copy_in``,
``embed.forward``, ``embed.copy_out``) and ``GalleryIndex.search``
(``search``). A span is on only while a ``torch.profiler`` session runs
somewhere in the process; off, it reads one flag and does nothing else. On,
it records its name, its host start and end (``time.perf_counter_ns``), its
thread, its parent (the span open on the same thread when it started), the
id of its top-level span (shared by the spans of one call), ``items`` (the
rows it works on) and, on a CUDA device, a pair of timing events on the
current stream, whose elapsed time is the span's stream time. It also opens
a ``record_function`` of its name, which a profiler that follows the thread
puts in its trace as a ``user_annotation`` above the span's kernels.
Finished spans go to one bounded, process-wide buffer.

How an operator gets spans: wrap the work in ``trace(log_dir)``, which
follows every thread, so ``log_dir/trace.json`` shows each thread's spans
above their kernels and ``spans()`` returns them with host and stream
milliseconds; or run any ``torch.profiler`` session around the work and read
``spans()`` (then ``clear()``) after it. ``spans()`` waits on the events, so
it is never called on the hot path.

``trace(log_dir)`` records a ``torch.profiler`` trace of the host and, where
a card is present, of CUDA, and writes it to ``log_dir/trace.json`` (Chrome
trace format; open it in Perfetto or ``chrome://tracing``). ``StepTimer``
times steps on the host clock and discards the first ``warmup``; given a
CUDA device it synchronises the card as a step starts and ends, so a step's
time includes the work it queued there.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from hairci_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on every thread; the trace lands in
    ``log_dir/trace.json``. Yields the profiler (``key_averages()`` for a
    table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


# -- spans ---------------------------------------------------------------

MAX_SPANS = 65_536          # finished spans kept; later ones are dropped

_lock = threading.Lock()    # guards _done and _dropped
_done: List["_Span"] = []
_dropped = 0
_ids = itertools.count(1)
_open = threading.local()   # .stack: this thread's open spans
_OFF = contextlib.nullcontext()


def span(name: str, items: Optional[int] = None, device: DeviceLike = None):
    """A context manager naming a region of the hot path. ``items``: the
    rows it works on; ``device``: where its work runs (stream times on a
    CUDA device). Off, when no profiler session runs in the process, it is
    a shared no-op."""
    # the module's flag is true in every thread while a session runs;
    # torch._C._autograd._profiler_enabled() is the calling thread's alone
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, items, device)


class _Span:
    __slots__ = ("name", "items", "id", "parent", "root", "thread", "t0",
                 "t1", "stream", "events", "_rf")

    def __init__(self, name: str, items: Optional[int], device: DeviceLike):
        self.name = name
        self.items = items
        dev = None if device is None else torch.device(device)
        self.stream = self.events = None
        if dev is not None and dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "_Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.thread = threading.get_ident()
        stack.append(self)
        # opened whenever a session runs: under profile_all_threads the
        # per-thread flag reads false on every thread, and a session that
        # does not follow this thread records nothing of it
        self._rf = _autograd_profiler.record_function(self.name)
        self._rf.__enter__()
        if self.events is not None:
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        self._rf.__exit__(*exc)
        self._rf = None
        _open.stack.pop()
        with _lock:
            if len(_done) < MAX_SPANS:
                _done.append(self)
            else:
                _dropped += 1
        return False


def spans() -> List[Dict[str, Any]]:
    """The finished spans in the order they finished, each a dict of
    ``name``, ``id``, ``parent``, ``root``, ``thread``, ``items``,
    ``start_ns``, ``host_ms`` and ``stream_ms`` (``None`` off a CUDA
    device). Waits on the spans' events."""
    with _lock:
        done = list(_done)
    out = []
    for s in done:
        stream_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            stream_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "root": s.root, "thread": s.thread, "items": s.items,
                    "start_ns": s.t0, "host_ms": (s.t1 - s.t0) * 1e-6,
                    "stream_ms": stream_ms})
    return out


def dropped() -> int:
    """Spans that finished past ``MAX_SPANS`` since the last ``clear()``."""
    return _dropped


def clear() -> None:
    """Empty the buffer and its count of dropped spans."""
    global _dropped
    with _lock:
        _done.clear()
        _dropped = 0


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
