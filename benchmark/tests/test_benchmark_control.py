"""The control: the reference put in the program's place one precision
step below the configuration's (fp8 products where the cells state bf16; a
TF32 search where the gallery is f32) must come out not correct. On the
CPU at the tiny cells' size; on a card at each cell's own size, on three
seeds (``-m cuda``)."""

from __future__ import annotations

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import benchmark_tiny  # noqa: E402

BENCH = benchmark_tiny.BENCH
REPO = benchmark_tiny.REPO


def _control_lines(root, workload, seeds, device):
    code = f"""
import control
control.main(["--workload", {workload!r}, "--side", "control",
              "--seeds", {",".join(map(str, seeds))!r}], device={device!r})
"""
    proc = benchmark_tiny.run_python(root, code, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = benchmark_tiny.make_copy(str(tmp_path_factory.mktemp("bench")))
    # the control stands in for a bf16 program: declare the tiny training
    # cell so (the program side of it runs in float32 on the CPU)
    path = os.path.join(root, "benchmark", "configs", "tiny-r18.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-retrieve"])
def test_the_control_is_not_correct_on_the_cpu(tiny, workload):
    (line,) = _control_lines(tiny, workload, [21], "cpu")
    assert line["fails"], line


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r50-sham-train", "vitb16-retrieve",
                                      "vitb16-sham-train"])
def test_the_control_is_not_correct_at_the_cells_size(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    lines = _control_lines(REPO, workload, [31, 32, 33], None)
    assert len(lines) == 3 and all(line["fails"] for line in lines), lines
