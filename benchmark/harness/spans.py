"""The program's own spans of one run (``hairci_torch.utils.profiling``),
for the per-layer metrics that read them.

The program records spans only while a profiler session runs, which in a
run is the traced window and the profiler's own start and stop. The stop
can take seconds and hold the interpreter's lock, so a request in flight
then runs long: spans that end later than the record's ``trace_window_s``
after the first span's start are left out. The first reader of a record
drains the program's buffer (``spans()``, then ``clear()``) into the
record's ``_spans``, so every reader of one run sees the same spans. A
program without spans, or a buffer that dropped spans past its bound,
gives none, and every reader then returns ``None``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def of(rec) -> List[Dict]:
    """The spans recorded in ``rec``'s run."""
    if "_spans" not in rec:
        rec["_spans"] = _in_window(_drain(), rec.get("trace_window_s"))
    return rec["_spans"]


def _drain() -> List[Dict]:
    try:
        from hairci_torch.utils import profiling
        read, dropped, clear = (profiling.spans, profiling.dropped,
                                profiling.clear)
    except (ImportError, AttributeError):
        return []
    out, lost = read(), dropped()
    clear()
    return [] if lost else out


def _in_window(spans: List[Dict], window_s) -> List[Dict]:
    """The spans that end within ``window_s`` of the first one's start."""
    if not spans or window_s is None:
        return spans
    cut = min(s["start_ns"] for s in spans) + window_s * 1e9
    return [s for s in spans if s["start_ns"] + s["host_ms"] * 1e6 <= cut]


def _values(rec, name: str, field: str) -> Optional[List[float]]:
    vals = [s[field] for s in of(rec) if s["name"] == name]
    if not vals or any(v is None for v in vals):
        return None
    return vals


def per_step(rec, name: str, field: str = "stream_ms") -> Optional[float]:
    """A training span's ``field`` summed over the traced window, over the
    number of ``sham.step`` spans there."""
    if rec.get("kind") != "train":
        return None
    vals, steps = _values(rec, name, field), _values(rec, "sham.step",
                                                      "host_ms")
    if vals is None or steps is None:
        return None
    return sum(vals) / len(steps)


def mean(rec, name: str, field: str) -> Optional[float]:
    """A retrieval span's ``field``, the mean over its occurrences."""
    if rec.get("kind") != "retrieve":
        return None
    vals = _values(rec, name, field)
    return None if vals is None else sum(vals) / len(vals)
