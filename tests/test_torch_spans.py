"""The port's spans (``hairci_torch.utils.profiling.span``).

Off, with no profiler session in the process, a span records nothing and
touches neither ``record_function``, CUDA events nor the clock. On, spans of
any thread are recorded with their thread, parent and top-level id, a card's
spans carry stream times from an event pair, the bounded buffer counts what
it drops, and ``trace()`` follows a worker thread. On the hot path: a SHAM
step yields the ``sham.*`` spans in the code's order with outputs bitwise
equal to a step without the profiler, and a request yields the
``embed.*`` and ``search`` spans, each with the request's row count.
``chip_smoke.py`` takes from the port only names it has, and its traced
data-parallel step times the recipe's draws through a span.
"""

import ast
import contextlib
import itertools
import json
import pathlib
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hairci_torch.models.resnet as port_resnet
from hairci_torch.retrieval.encoders import HairEncoder
from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.ssl.sham import SHAMRecipe
from hairci_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]
STEP = ["sham.step", "sham.augment", "sham.update", "sham.forward",
        "sham.augment", "sham.forward", "sham.backward", "sham.update"]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _boom(*args, **kwargs):
    raise AssertionError("touched with no profiler session")


def _off_touches_nothing(mp, owner=torch.autograd.profiler):
    """``owner``: where the span finds ``record_function`` (torch's own
    optimiser opens one of its own, so a step patches the span's view)."""
    mp.setattr(owner, "record_function", _boom, raising=False)
    mp.setattr(torch.cuda, "Event", _boom)
    mp.setattr(torch.cuda, "current_stream", _boom)
    mp.setattr(profiling, "time", SimpleNamespace(
        perf_counter_ns=_boom, perf_counter=time.perf_counter))


def _by_start(spans):
    return sorted(spans, key=lambda s: s["id"])


def test_off_a_span_records_and_touches_nothing(monkeypatch):
    _off_touches_nothing(monkeypatch)
    first = profiling.span("a", 3, "cuda")
    with first, profiling.span("b", 1, "cuda:0"):
        pass
    assert profiling.span("c") is first   # one shared no-op
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_worker_threads_spans_are_recorded_while_the_main_thread_profiles():
    def work():
        with profiling.span("outer", 4):
            with profiling.span("inner", 4):
                torch.ones(8) + 1
            with profiling.span("inner", 4):
                pass

    with torch.profiler.profile(activities=CPU):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with profiling.span("main"):
            pass
    with profiling.span("after"):     # the session is over: off again
        pass
    got = _by_start(profiling.spans())
    assert [s["name"] for s in got] == ["outer", "inner", "inner", "main"]
    outer, a, b, main = got
    assert outer["thread"] == a["thread"] == b["thread"] == t.ident
    assert main["thread"] == threading.get_ident() != t.ident
    assert outer["parent"] is None and a["parent"] == b["parent"] == outer["id"]
    assert a["root"] == b["root"] == outer["root"] == outer["id"]
    assert main["parent"] is None and main["root"] == main["id"]
    assert [s["items"] for s in got] == [4, 4, 4, None]
    assert all(s["stream_ms"] is None for s in got)
    assert outer["host_ms"] >= a["host_ms"] + b["host_ms"] > 0
    assert outer["start_ns"] <= a["start_ns"] <= b["start_ns"]


def test_spans_past_the_bound_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with torch.profiler.profile(activities=CPU):
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s["name"] for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


class _FakeEvent:
    """A CUDA timing event on a clock that ticks once a record."""
    clock = itertools.count()

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = self.synced = None

    def record(self, stream=None):
        self.stream, self.t = stream, next(self.clock)

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced and self.stream == end.stream == "stream"
        return float(end.t - self.t)


def test_on_a_card_a_span_times_its_stream_with_an_event_pair(monkeypatch):
    asked = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: asked.append(device) or "stream")
    with torch.profiler.profile(activities=CPU):
        with profiling.span("card", 5, "cuda:0"):
            with profiling.span("inner", 5, torch.device("cuda", 0)):
                pass
        with profiling.span("host", 5, "cpu"):
            pass
    by = {s["name"]: s for s in profiling.spans()}
    # the outer pair's records fall around the inner pair's two
    assert by["card"]["stream_ms"] == 3.0 and by["inner"]["stream_ms"] == 1.0
    assert by["host"]["stream_ms"] is None
    assert asked == [torch.device("cuda", 0)] * 2


def test_concurrent_spans_lose_none():
    threads, n = 16, 200

    def work():
        for _ in range(n):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.spans()
    assert len(got) == 2 * threads * n == len({s["id"] for s in got})
    by_id = {s["id"]: s for s in got}
    for s in got:
        if s["name"] == "inner":
            up = by_id[s["parent"]]
            assert up["name"] == "outer" and up["thread"] == s["thread"]
            assert s["root"] == up["id"] == up["root"]


def test_trace_follows_a_worker_threads_span(tmp_path):
    def work():
        with profiling.span("worker.span", 2):
            torch.ones(16, 16) @ torch.ones(16, 16)

    with profiling.trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    hits = [e for e in events if e.get("name") == "worker.span"]
    assert [e["cat"] for e in hits] == ["user_annotation"]
    (ann,) = hits
    assert ann["tid"] == t.native_id
    # the worker's matmul lies inside the span, on the same thread
    assert any(e.get("cat") == "cpu_op" and e.get("tid") == t.native_id
               and ann["ts"] <= e["ts"] <= ann["ts"] + ann["dur"]
               for e in events if e.get("name") == "aten::mm")
    assert [s["name"] for s in profiling.spans()] == ["worker.span"]


# -- the hot path --------------------------------------------------------

B, S = 4, 32


def _sham_steps(profile: bool):
    """Two steps (warmup, mine) of a one-block-a-stage ResNet-18 SHAM on
    the CPU, from the same seeded state: the outputs and the state."""
    recipe = SHAMRecipe(backbone="resnet18", img_size=S, num_batches=2,
                        weight_decay=1e-4)
    state = recipe.create_state(0, B, torch.device("cpu"))
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, S, S, 3), dtype=np.uint8))
    outs = []
    ctx = (torch.profiler.profile(activities=CPU) if profile
           else contextlib.nullcontext())
    with ctx:
        for c, stage in enumerate(("warmup", "mine")):
            outs.append(recipe.train_step(
                state, images, torch.Generator().manual_seed(c),
                stage=stage, batch_id=1, k=2))
    return outs, state


def test_a_sham_step_yields_its_spans_in_order_and_the_same_bits(
        monkeypatch):
    monkeypatch.setitem(port_resnet._STAGES, "resnet18",
                        ([1, 1, 1, 1], port_resnet.BasicBlock))
    with pytest.MonkeyPatch.context() as off:
        off.setattr(profiling, "_autograd_profiler", SimpleNamespace(
            _is_profiler_enabled=torch.autograd.profiler._is_profiler_enabled))
        _off_touches_nothing(off, profiling._autograd_profiler)
        plain, plain_state = _sham_steps(profile=False)
    assert profiling.spans() == []
    traced, traced_state = _sham_steps(profile=True)

    for p, t in zip(plain, traced):
        assert p.keys() == t.keys()
        for key in p:
            assert torch.equal(p[key], t[key]), key
    for mod in ("online", "ema"):
        want = getattr(plain_state, mod).state_dict()
        got = getattr(traced_state, mod).state_dict()
        assert all(torch.equal(want[n], got[n]) for n in want), mod
    assert torch.equal(plain_state.neg_indices, traced_state.neg_indices)

    got = _by_start(profiling.spans())
    assert [s["name"] for s in got] == STEP * 2
    for step in (got[:len(STEP)], got[len(STEP):]):
        top = step[0]
        assert top["parent"] is None and top["root"] == top["id"]
        assert all(s["parent"] == top["id"] and s["root"] == top["id"]
                   for s in step[1:])
        assert all(s["items"] == B and s["stream_ms"] is None for s in step)
        assert top["host_ms"] >= sum(s["host_ms"] for s in step[1:])


@pytest.fixture(scope="module")
def encoder():
    return HairEncoder(model_name="vit_tiny_patch16", device="cpu",
                       dtype=torch.float32)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_a_request_yields_the_embed_and_search_spans_with_its_rows(
        encoder, use_kernel):
    rng = np.random.default_rng(1)
    gallery = rng.normal(size=(40, encoder.feature_dim)).astype(np.float32)
    index = GalleryIndex(gallery, [str(i) for i in range(40)], chunk=16,
                         use_kernel=use_kernel, device="cpu")
    crops = rng.integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    want = index.search(encoder.extract_features(crops), 5)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=CPU):
        emb = encoder.extract_features(crops)
        got = index.search(emb, 5)
        one = index.search(emb[0], 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(one[1], want[1][:1])
    spans = _by_start(profiling.spans())
    assert [s["name"] for s in spans] == ["embed.copy_in", "embed.forward",
                                          "embed.copy_out", "search",
                                          "search"]
    assert [s["items"] for s in spans] == [3, 3, 3, 3, 1]
    assert all(s["parent"] is None and s["root"] == s["id"] for s in spans)


REPO = pathlib.Path(__file__).resolve().parents[1]


def test_chip_smoke_takes_only_names_the_port_has():
    """Each ``from hairci_torch... import name`` of ``chip_smoke.py``
    (most of them inside the phases, which run only on a card)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    wanted = [(n.module, a.name) for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module
              and n.module.split(".")[0] == "hairci_torch" for a in n.names]
    assert any(m == "hairci_torch.utils.profiling" for m, _ in wanted)
    missing = []
    for module, name in wanted:
        mod = __import__(module, fromlist=[name])
        if not hasattr(mod, name):
            try:
                __import__(f"{module}.{name}")
            except ImportError:
                missing.append(f"{module}.{name}")
    assert missing == []


def test_chip_smoke_dp_profile_times_the_draws_under_a_span(monkeypatch):
    """``chip_smoke._dp_profile`` (``--ranks N --profile``) on the CPU, the
    card's syncs made no-ops: the draws are timed through ``dp_draw``, the
    recipe gets its own ``draw`` back and the span buffer is left empty."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    class Recipe:
        def draw(self, n):
            time.sleep(0.005)
            return torch.ones(n, 4)

    rec = Recipe()

    def step(state, x, i):
        with profiling.span("sham.step", 2):
            return rec.draw(2) @ x

    out = chip_smoke._dp_profile(rec, None, step, torch.ones(4, 4))
    assert 5.0 <= out["draw_ms"] <= out["wall_ms"]
    assert out["busy_ms"] == 0.0 and out["nccl_ms"] == 0.0
    assert "draw" not in vars(rec)
    assert profiling.spans() == [] and profiling.dropped() == 0
