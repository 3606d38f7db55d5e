"""A throwaway copy of the benchmark with tiny cells, for the benchmark's
CPU tests: the cells are added as files (a configuration, a traffic mix)
and as entries of a copy of ``BENCHMARK.json``; no existing file is edited.

The tiny cells keep the drivers, the references and the limits of the real
ones and cut only what the CPU cannot run: ResNet-18 at 32 px and B=8 for
training (in float32, where the reference agrees to rounding), ViT-Ti/16
at 224 px over 1,000 gallery rows for retrieval.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def make_copy(dst: str) -> str:
    """``dst`` with ``benchmark/`` copied, the port linked beside it, and
    the tiny cells ``tiny-train`` and ``tiny-retrieve`` added."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "hairci_torch"),
               os.path.join(dst, "hairci_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)

    def add(name, config, cfg, traffic_name, traffic, like):
        with open(os.path.join(dst, "benchmark", "configs",
                               config + ".json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(dst, "benchmark", "traffic",
                               traffic_name + ".json"), "w") as f:
            json.dump(traffic, f)
        bench["configs"].append({"name": config, "source": "a test",
                                 "file": f"benchmark/configs/{config}.json",
                                 "reduced": [], "why": "a test"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic_name, "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)

    def load(path):
        with open(os.path.join(BENCH, path)) as f:
            return json.load(f)

    cfg = load("configs/resnet50-sham.json")
    cfg.update(img_size=32, batch_size=8, dtype="float32")
    cfg["model"] = {"kind": "resnet", "backbone": "resnet18",
                    "arch": {"stages": [2, 2, 2, 2], "block": "basic",
                             "stem": "imagenet", "width": 64},
                    "proj": [512, 128]}
    tr = load("traffic/train_mined_b256.json")
    tr.update(batch=8, batch_ids=4, trace_seconds=0.5)
    add("tiny-train", "tiny-r18", cfg, "tiny_train", tr, "r50-sham-train")

    cfg = load("configs/vitb16-sham.json")
    cfg["model"].update(serve_name="vit_tiny_patch16",
                        arch={"width": 192, "depth": 12, "heads": 3,
                              "mlp": 768, "patch": 16})
    cfg["serve"]["gallery_rows"] = 1000
    tr = load("traffic/retrieve_closed_c1_q16-128.json")
    tr.update(sizes=[2, 4, 8, 16], query_pool=48, sample_requests=4,
              trace_seconds=0.5)
    add("tiny-retrieve", "tiny-vit", cfg, "tiny_retrieve", tr,
        "vitb16-retrieve")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def run_python(root: str, code: str, timeout: float = 600):
    """Run ``code`` in a fresh interpreter at ``root`` with the copy's
    ``benchmark/`` on the path; returns the completed process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "benchmark"))
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def result_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
