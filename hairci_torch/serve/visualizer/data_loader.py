"""JSON loading + format normalization — parity with
the reference's `Visualizer/app/models/data_loader.py:28-44`: benchmarks may
use `query_image` or `query_id` keys; korean files munge `_query.jpg` keys.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List


def load_benchmark(path: str) -> Dict[str, List[str]]:
    """query name → ground-truth list."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for item in data:
        q = item.get("query_image") or item.get("query_id") or item.get("query")
        if q is None:
            continue
        q = os.path.basename(str(q))
        if q.endswith("_query.jpg"):  # korean key munging
            q = q.replace("_query.jpg", ".jpg")
        out[q] = [os.path.basename(g) for g in
                  (item.get("ground_truth") or item.get("ground_truths") or [])]
    return out


def load_results(path: str) -> Dict[str, List[str]]:
    """query name → ranked top-100 list (`{"query": ..., "top100": [...]}`
    or `{"query_id": ..., "results": [...]}`)."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for item in data:
        q = item.get("query") or item.get("query_id") or item.get("query_image")
        if q is None:
            continue
        ranked = item.get("top100") or item.get("results") or []
        out[os.path.basename(str(q))] = [os.path.basename(r) for r in ranked]
    return out
