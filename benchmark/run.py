"""Run one cell of the benchmark of ``hairci_torch`` on the card(s) of this
machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration, its traffic mix and its metrics are found by
name in ``BENCHMARK.json`` and in the files under ``benchmark/``
(``README.md`` there says how). With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a device trace of part of the window. Every run checks what the timed
path produced against the plain reference (``correct``) and prints each
number compared beside its limit, on standard error and under ``checks``,
the last key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches():
    """Every build and kernel cache at a fixed place inside the checkout,
    so that only a checkout's first run builds. (The port's nvcc and g++
    builds already live in ``hairci_torch/{ops,native}/_build/``.)"""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def run_cell(args, device=None, program=None):
    """The cell's record and result line, or an exit code when the run must
    print no result. ``device`` set skips the look for a card (the
    benchmark's own tests run on the CPU that way)."""
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import spec

    cell = spec.load_cell(args.workload, ROOT, HERE)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 2, None
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} cards, this machine "
                  f"has {torch.cuda.device_count()}", file=sys.stderr)
            return 2, None
        device = "cuda"
    driver = spec.driver(cell)
    rec = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START, program=program)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(cell, m.name).read(rec)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    limits = cell.config["limits"][cell.traffic["driver"]]
    checks = {name: {"value": float(rec["checks"][name]),
                     "limit": float(limit)}
              for name, limit in limits.items()}
    correct = (rec["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = torch.device(device)
    result = {
        "correct": bool(correct),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(rec["peak_bytes"]),
        },
    }
    if args.trace and "trace" in rec:
        tr = rec["trace"]
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = rec["trace_window_s"]
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = checks
    return 0, (rec, result)


def main(argv=None, device=None) -> int:
    args = _args(argv)
    _caches()
    code, out = run_cell(args, device)
    if code:
        return code
    rec, result = out
    from harness import guard

    found = guard.forbidden()
    if found:
        print("modules that no run may load were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, value in rec["checks"].items():
        if name not in result["checks"]:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
