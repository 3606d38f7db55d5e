"""The per-layer metrics read from the program's own spans
(``harness/spans.py``): each reader's arithmetic on synthetic spans,
``None`` where a span or its stream time is missing, and one drain of the
program's buffer a record."""

from __future__ import annotations

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import spans as spans_lib  # noqa: E402
from harness import spec  # noqa: E402
from hairci_torch.utils import profiling  # noqa: E402


def _span(name, host, stream=None, items=256):
    return {"name": name, "id": 0, "parent": None, "root": 0, "thread": 1,
            "items": items, "start_ns": 0, "host_ms": host,
            "stream_ms": stream}


# two traced steps; a phase entered twice a step has two spans
TRAIN = ([_span("sham.step", 30.0, 100.0), _span("sham.step", 40.0, 110.0)]
         + [_span("sham.augment", 0.1, v) for v in (1.0, 2.0, 3.0, 4.0)]
         + [_span("sham.forward", 0.1, v) for v in (10.0, 20.0, 11.0, 21.0)]
         + [_span("sham.backward", 0.1, v) for v in (50.0, 60.0)]
         + [_span("sham.update", 0.1, v) for v in (5.0, 6.0, 7.0, 8.0)])
RETRIEVE = [_span("embed.copy_in", 1.0, 9.0, 16),
            _span("embed.copy_in", 3.0, 9.0, 128),
            _span("embed.forward", 5.0, 20.0, 16),
            _span("embed.forward", 7.0, 30.0, 128),
            _span("embed.copy_out", 10.0, 0.5, 16),
            _span("embed.copy_out", 20.0, 0.5, 128),
            _span("search", 4.0, 1.0, 16), _span("search", 4.0, 2.0, 128)]
WANT = {"augment_ms.train": 5.0, "forward_ms.train": 31.0,
        "backward_ms.train": 55.0, "update_ms.train": 13.0,
        "step_host_ms.train": 35.0, "embed_copy_ms.retrieve": 2.0,
        "embed_launch_ms.retrieve": 6.0, "embed_device_ms.retrieve": 25.0,
        "embed_wait_ms.retrieve": 15.0, "search_device_ms.retrieve": 1.5}
STREAM = {"augment_ms.train", "forward_ms.train", "backward_ms.train",
          "update_ms.train", "embed_device_ms.retrieve",
          "search_device_ms.retrieve"}


class Program:
    """The program's span buffer, as the helper reads it."""

    def __init__(self, monkeypatch, buffer, dropped=0):
        self.buffer, self.lost, self.drains = list(buffer), dropped, 0
        monkeypatch.setattr(profiling, "spans", self.spans)
        monkeypatch.setattr(profiling, "dropped", lambda: self.lost)
        monkeypatch.setattr(profiling, "clear", self.clear)

    def spans(self):
        self.drains += 1
        return list(self.buffer)

    def clear(self):
        self.buffer, self.lost = [], 0


def _read(name, rec):
    return spec.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                            "m_" + name.replace(".", "_")).read(rec)


def _rec(kind):
    return {"kind": kind}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_on_synthetic_spans(monkeypatch, name):
    kind = "train" if name.endswith(".train") else "retrieve"
    Program(monkeypatch, TRAIN if kind == "train" else RETRIEVE)
    assert _read(name, _rec(kind)) == pytest.approx(WANT[name])
    # the other kind of cell reads nothing
    other = "retrieve" if kind == "train" else "train"
    Program(monkeypatch, TRAIN + RETRIEVE)
    assert _read(name, _rec(other)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_where_a_span_or_its_stream_time_is_missing(monkeypatch, name):
    kind = "train" if name.endswith(".train") else "retrieve"
    spans = TRAIN if kind == "train" else RETRIEVE
    # no spans at all: a run without a profiler, or a program without spans
    Program(monkeypatch, [])
    assert _read(name, _rec(kind)) is None
    # spans off a card carry no stream time
    Program(monkeypatch, [dict(s, stream_ms=None) for s in spans])
    host = _read(name, _rec(kind))
    assert (host is None) == (name in STREAM)
    # the span a reader needs is missing (``sham.step`` for a training
    # reader's count of steps)
    need = {"augment_ms.train": "sham.augment",
            "embed_copy_ms.retrieve": "embed.copy_in",
            "embed_launch_ms.retrieve": "embed.forward",
            "embed_device_ms.retrieve": "embed.forward",
            "embed_wait_ms.retrieve": "embed.copy_out",
            "search_device_ms.retrieve": "search"}.get(name, "sham.step")
    Program(monkeypatch, [s for s in spans if s["name"] != need])
    assert _read(name, _rec(kind)) is None
    # a buffer that dropped spans past its bound is not read
    Program(monkeypatch, spans, dropped=1)
    assert _read(name, _rec(kind)) is None


def test_a_program_without_spans_gives_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert spans_lib.of(_rec("train")) == []
    assert _read("forward_ms.train", _rec("train")) is None


def test_the_helper_drains_the_buffer_once_a_record(monkeypatch):
    prog = Program(monkeypatch, TRAIN)
    rec = _rec("train")
    got = {n: _read(n, rec) for n in WANT if n.endswith(".train")}
    assert got == pytest.approx({n: WANT[n] for n in got})
    assert prog.drains == 1 and prog.buffer == []
    # the spans live on the record: a copy of it reads them too
    assert _read("backward_ms.train", dict(rec)) == pytest.approx(55.0)
    assert prog.drains == 1
    # the next run's record drains again, and sees only its own spans
    prog.buffer = TRAIN[:2] + TRAIN[-4:]
    rec2 = _rec("train")
    assert _read("update_ms.train", rec2) == pytest.approx(13.0)
    assert _read("forward_ms.train", rec2) is None
    assert prog.drains == 2


def test_spans_past_the_traced_window_are_left_out(monkeypatch):
    """A request in flight while the profiler stops runs long, past the
    window: its spans are not read."""
    ms = 1e6
    late = [dict(_span("embed.copy_in", 1.0), start_ns=0),
            dict(_span("embed.copy_in", 3.0), start_ns=int(10 * ms)),
            dict(_span("embed.copy_in", 900.0), start_ns=int(20 * ms))]
    Program(monkeypatch, late)
    rec = {"kind": "retrieve", "trace_window_s": 0.5}
    assert _read("embed_copy_ms.retrieve", rec) == pytest.approx(2.0)
    Program(monkeypatch, late)
    rec = {"kind": "retrieve", "trace_window_s": 1.0}
    assert _read("embed_copy_ms.retrieve", rec) == pytest.approx(904 / 3)
