"""``torch.profiler`` over a traced window, read back as a ``Trace``."""

from __future__ import annotations

import os
import tempfile

import torch

from harness import trace as trace_lib


def profiler(device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read_trace(prof) -> trace_lib.Trace:
    """The stopped profiler's events, through its Chrome trace (written to
    the run's ``TMPDIR`` and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_lib.load(path)
    finally:
        os.unlink(path)
