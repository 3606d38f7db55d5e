"""The benchmark's harness on the CPU: finding cells by name, a cell added
as files only, the retrieval schedule, the trace reduction, the
percentile, the analytic FLOPs, the import guard and the reference against
hand computation."""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import benchmark_tiny  # noqa: E402
from harness import data, guard, spec, stats, trace  # noqa: E402

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCHMARK = json.load(_f)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = spec.load_cell(name, REPO, BENCH)
    assert spec.driver(cell).run
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(cell, m.name).read), m.name
    assert os.path.exists(os.path.join(
        BENCH, "reference", cell.config["model"]["kind"] + ".py"))
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert set(cell.config["limits"][cell.traffic["driver"]])


def test_bench_file_names_files_under_paths():
    for c in BENCHMARK["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for m in BENCHMARK["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return benchmark_tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


def _run_cell(root, workload, seed, seconds=1.0, trace_=0, fault=""):
    code = f"""
import json, sys
import run
{fault}
args = run._args(["--workload", {workload!r}, "--seed", "{seed}",
                  "--seconds", "{seconds}", "--trace", "{trace_}"])
code, out = run.run_cell(args, device="cpu",
                         program=globals().get("program"))
rec, result = out
from harness import guard
print(json.dumps({{"result": result, "forbidden": guard.forbidden(),
                  "schedule": [(q["c"], q["r"], q["size"], q["start"])
                               for q in rec.get("requests", [])]}}))
"""
    proc = benchmark_tiny.run_python(root, code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return benchmark_tiny.result_line(proc.stdout)


def test_throwaway_training_cell_runs_from_files_alone(tiny):
    out = _run_cell(tiny, "tiny-train", 2 ** 31 + 77)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_img_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert out["forbidden"] == []


def test_throwaway_retrieval_cell_runs_and_main_prints_one_line(tiny):
    code = ("import run, sys\n"
            "sys.exit(run.main(['--workload', 'tiny-retrieve', '--seed', "
            "'3', '--seconds', '1', '--trace', '0'], device='cpu'))")
    proc = benchmark_tiny.run_python(tiny, code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = benchmark_tiny.result_line(proc.stdout)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"retrieve_img_per_s", "retrieve_p95_ms",
                                   "setup_s"}
    assert proc.stderr.strip().splitlines()[-1].startswith("check topk ")


def test_retrieval_sizes_and_order_do_not_depend_on_the_seed(tiny):
    a = {tuple(q[:2]): q[2:] for q in
         _run_cell(tiny, "tiny-retrieve", 5, seconds=4)["schedule"]}
    b = {tuple(q[:2]): q[2:] for q in
         _run_cell(tiny, "tiny-retrieve", 2 ** 33 + 1, seconds=4)["schedule"]}
    both = set(a) & set(b)
    assert len(both) > 4
    assert all(a[key] == b[key] for key in both)
    from drivers.retrieve_closed import schedule
    tr = {"clients": 2, "sizes": [16, 32, 64, 128], "query_pool": 512}
    assert [schedule(tr, 0, r)[0] for r in range(6)] == [16, 32, 64, 128,
                                                         16, 32]
    assert [schedule(tr, 1, r)[0] for r in range(4)] == [64, 128, 16, 32]


def test_idle_share_counts_overlapping_device_work_once():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 14, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 18, "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 17,
         "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 40},
    ]
    t = trace.from_events(ev)
    assert t.busy_s() == pytest.approx(26e-6)        # [0, 16] + [30, 40]
    assert t.span() == (0.0, 40.0)
    assert t.kernel_s("a") == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps())
    # the gap [16, 30]: 4 us under the launch, the rest under the innermost
    # CPU op covering its middle
    assert gaps == {"aten::mm": pytest.approx(10e-6),
                    "cudaLaunchKernel": pytest.approx(4e-6)}
    assert t.top_ops(1) == [["a", pytest.approx(20e-6)]]
    empty = trace.from_events([])
    assert empty.busy_s() == 0 and empty.idle_gaps() == []


def test_p95_is_over_every_request():
    rng = np.random.default_rng(0)
    lat = rng.exponential(20.0, 1537).tolist()
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    sys.path.insert(0, os.path.join(BENCH, "metrics"))
    reader = spec.load_module(os.path.join(BENCH, "metrics",
                                           "retrieve_p95_ms.py"), "p95")
    rec = {"kind": "retrieve", "latency_ms": lat}
    assert reader.read(rec) == pytest.approx(np.percentile(lat, 95))


@pytest.mark.parametrize("kind", ["resnet50", "vitb16"])
def test_model_flops_match_flop_counter(kind, monkeypatch):
    """On the plain model without recomputation (the references checkpoint
    their blocks to fit the cell's batch; that is switched off here)."""
    from torch.utils.flop_counter import FlopCounterMode

    from reference import resnet, sham, vit
    for mod in (resnet, vit):
        monkeypatch.setattr(mod, "maybe_checkpoint", lambda fn, *a: fn(*a))
    name = {"resnet50": "resnet50-sham", "vitb16": "vitb16-sham"}[kind]
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["batch_size"] = 1
    ref = sham.ShamReference(cfg, "cpu")
    p = {n: t.requires_grad_(not n.endswith(sham.BUFFERS))
         for n, t in data.make_params(ref.leaves, 0, "cpu").items()}
    x = torch.rand(1, 224, 224, 3)
    with FlopCounterMode(display=False) as fc:
        y, _ = ref.forward(p, x, train=False)
    mod = resnet if kind == "resnet50" else vit
    f = mod.forward_flops(cfg["model"]["arch"], 224)
    hidden, out = cfg["model"]["proj"]
    d = (resnet.num_features(cfg["model"]["arch"]) if kind == "resnet50"
         else cfg["model"]["arch"]["width"])
    fwd = f["total"] + 2.0 * (d * hidden + hidden * out)
    assert fc.get_total_flops() == fwd
    with FlopCounterMode(display=False) as fc:
        y, _ = ref.forward(p, x, train=False)
        y.sum().backward()
    assert fc.get_total_flops() == 3 * fwd - f["first"]
    # a step: 3B rows forward and backward, B rows of the EMA forward
    assert sham.step_flops(cfg, 4) == 12 * (3 * fwd - f["first"]) + 4 * fwd


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["hairci_torch", "hairci_torch.ops", "jaxlib.x",
                            "hairci.models", "flaxx", "chip_smoke",
                            "jax"]) == ["chip_smoke", "hairci.models", "jax",
                                        "jaxlib.x"]


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    code = """
import glob, os, sys, importlib
sys.path.insert(0, os.getcwd())
import run, control
from harness import guard, spec
for m in ("harness.data", "harness.trace", "harness.profiling",
          "drivers.sham_train", "drivers.retrieve_closed", "reference.sham",
          "reference.retrieve", "reference.aug"):
    importlib.import_module(m)
for path in glob.glob("metrics/*.py"):
    spec.load_module(path, "m_" + os.path.basename(path).replace(".", "_"))
import hairci_torch.ssl.sham, hairci_torch.retrieval.encoders
import hairci_torch.retrieval.index
print(guard.forbidden())
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    import subprocess
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_reference_losses_and_adamw_against_hand_computation():
    from reference import sham
    z0 = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    z1 = torch.tensor([[0.6, 0.8], [0.8, -0.6]])
    t = 0.5
    z = np.concatenate([z0.numpy(), z1.numpy()])
    sim = z @ z.T / t
    loss = 0.0
    for i in range(4):
        others = [j for j in range(4) if j != i]
        pos = (i + 2) % 4
        loss += -(sim[i, pos] - math.log(sum(math.exp(sim[i, j])
                                             for j in others)))
    assert float(sham.nt_xent(z0, z1, t)) == pytest.approx(loss / 4,
                                                           rel=1e-6)
    a, p, n = (torch.tensor([[0.0, 0.0]]), torch.tensor([[3.0, 4.0]]),
               torch.tensor([[1.0, 0.0]]))
    d_ap = math.hypot(3 + 1e-6, 4 + 1e-6)
    d_an = math.hypot(-1 + 1e-6, 1e-6)
    assert float(sham.triplet(a, p, n, 0.5)) == pytest.approx(
        d_ap - d_an + 0.5, rel=1e-6)
    # Smooth-AP with two views of two samples, by hand
    e = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.8, 0.6], [0.6, -0.8]])
    zz = e / e.norm(dim=1, keepdim=True)
    s = (zz @ zz.T).numpy()
    tgt = [0, 1, 0, 1]
    aps = []
    for q in range(4):
        pos = [j for j in range(4) if j != q and tgt[j] == tgt[q]]
        every = [j for j in range(4) if j != q]
        sig = lambda i, j: 1 / (1 + math.exp(-(s[q, j] - s[q, i]) / 0.1))
        ap = sum((1 + sum(sig(i, j) for j in pos))
                 / (1 + sum(sig(i, j) for j in every) + 1e-8)
                 for i in pos) / (len(pos) + 1e-8)
        aps.append(ap)
    assert float(sham.smooth_ap(e, 0.1, 2)) == pytest.approx(
        1 - sum(aps) / 4, rel=1e-5)


def test_reference_step_matches_a_hand_adamw_step():
    """One reference step of a tiny ResNet, against its own loss and
    gradient carried through the clip, the decoupled decay and Adam's first
    step by hand in float64."""
    from reference import sham
    with open(os.path.join(BENCH, "configs", "resnet50-sham.json")) as f:
        cfg = json.load(f)
    cfg.update(img_size=32)
    cfg["model"] = {"kind": "resnet", "backbone": "resnet18",
                    "arch": {"stages": [1, 1, 1, 1], "block": "basic",
                             "stem": "imagenet", "width": 8},
                    "proj": [16, 8]}
    ref = sham.ShamReference(cfg, "cpu")
    out = ref.run(9, 4, 1, "mine", 3)
    leaves = data.make_params(ref.leaves, 9, "cpu")
    params = {n: t.clone().requires_grad_(True) for n, t in leaves.items()
              if not n.endswith(sham.BUFFERS)}
    bufs = {n: t for n, t in leaves.items() if n.endswith(sham.BUFFERS)}
    ema = {n: t.clone() for n, t in leaves.items()}
    images = data.make_images(4, 32, 9, (data.IMAGES, 0), "cpu")
    loss, grads, _ = ref._loss_and_grads(params, bufs, ema, images,
                                         data.step_generator(9, 0), "mine",
                                         0, 3, {})
    assert out["loss"] == [pytest.approx(float(loss), rel=1e-6)]
    r = cfg["sham"]
    g64 = {n: g.double() for n, g in grads.items()}
    total = math.sqrt(sum(float((g * g).sum()) for g in g64.values()))
    scale = 1.0 if total < 1.0 else 1.0 / total
    for n, p in params.items():
        g = g64[n] * scale
        p0 = leaves[n].double()
        # the decay in float32, as the optimiser takes it: 1 - 1e-7 is
        # itself rounded, which is most of a leaf's change where it has no
        # gradient
        decayed = (leaves[n] * (1.0 - r["lr"] * r["weight_decay"])
                   if sham.decays(n, p.shape) else leaves[n]).double()
        p1 = decayed - r["lr"] * g / (g.abs() + 1e-8)
        assert out["grad"][n] == pytest.approx(float(g.norm()), rel=1e-5,
                                               abs=1e-12), n
        assert out["delta"][n] == pytest.approx(float((p1 - p0).norm()),
                                                rel=1e-4, abs=1e-9), n
