"""``hairci_torch.utils.seeding`` and ``hairci_torch.utils.profiling``
against their JAX counterparts' behaviour: ``set_seed`` seeds python, numpy
and torch and returns a seeded generator; ``trace`` writes a Chrome trace
holding the region a ``span`` names; ``StepTimer`` keeps the steps after its
warmup, with the JAX timer's mean and p50."""

import json
import random
import time

import numpy as np
import pytest
import torch

from hairci.utils.profiling import StepTimer as JaxStepTimer
from hairci.utils.seeding import set_seed as jax_set_seed
from hairci_torch.cli import knn_classification, mainpretrain
from hairci_torch.utils import profiling
from hairci_torch.utils.seeding import set_seed


def test_set_seed_seeds_every_generator():
    gen = set_seed(5)
    draws = (random.random(), np.random.random(), torch.rand(1).item(),
             torch.rand(1, generator=gen).item())
    gen = set_seed(5)
    assert draws == (random.random(), np.random.random(),
                     torch.rand(1).item(), torch.rand(1, generator=gen).item())
    # python and numpy land where the JAX package's set_seed leaves them
    jax_set_seed(5)
    assert (random.random(), np.random.random()) == draws[:2]
    # the CLIs seed through it; mainpretrain keeps the name importable
    assert mainpretrain.set_seed is set_seed
    assert knn_classification.set_seed is set_seed


def test_trace_writes_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("hairci_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "hairci_step" in names
    assert any(e.key == "hairci_step" for e in prof.key_averages())


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_step_timer_matches_jax(warmup):
    sleeps = [0.004, 0.002, 0.006, 0.003, 0.005]
    timers = (profiling.StepTimer(warmup=warmup, device="cpu"),
              JaxStepTimer(warmup=warmup))
    for t in timers:
        for s in sleeps:
            with t:
                time.sleep(s)
    ours, theirs = timers
    kept = ours._times
    assert len(kept) == len(sleeps) - warmup == len(theirs._times)
    for got, want in zip(kept, sleeps[warmup:]):
        assert want <= got < want + 0.05
    # the same reductions of the kept times
    assert ours.mean == sum(kept) / len(kept)
    assert ours.p50 == sorted(kept)[len(kept) // 2]
    assert abs(ours.p50 - theirs.p50) < 0.02
    assert profiling.StepTimer().mean == profiling.StepTimer().p50 == 0.0


def test_step_timer_synchronises_only_a_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    with profiling.StepTimer(device="cpu"):
        pass
    assert calls == []
    with profiling.StepTimer(device="cuda:0"):
        pass
    assert calls == [torch.device("cuda:0")] * 2
