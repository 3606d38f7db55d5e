"""Dataset configuration — parity with
the reference's `Visualizer/app/config/datasets.py:13-41`: per-dataset
static mounts + dynamic model discovery from result directories.
"""

from __future__ import annotations

import os
from typing import Dict, List


def default_datasets(data_root: str = "data") -> Dict[str, dict]:
    """DATASETS dict: hairstyle (split hair/face mounts) + korean (single)."""
    return {
        "hairstyle": {
            "name": "Hairstyle benchmark",
            "benchmark": os.path.join(data_root, "hairstyle",
                                      "benchmark.json"),
            "results_dir": os.path.join(data_root, "hairstyle", "results"),
            "mounts": {
                "hair": os.path.join(data_root, "hairstyle", "hair"),
                "face": os.path.join(data_root, "hairstyle", "face"),
            },
        },
        "korean": {
            "name": "K-hairstyle benchmark",
            "benchmark": os.path.join(data_root, "korean", "benchmark.json"),
            "results_dir": os.path.join(data_root, "korean", "results"),
            "mounts": {
                "images": os.path.join(data_root, "korean", "images"),
            },
        },
    }


def discover_models(results_dir: str) -> List[str]:
    """Models = `<model>_top100_results.json` files in the results dir
    (`datasets.py` dynamic discovery)."""
    if not os.path.isdir(results_dir):
        return []
    out = []
    for f in sorted(os.listdir(results_dir)):
        if f.endswith("_top100_results.json"):
            out.append(f[: -len("_top100_results.json")])
    return out
