"""Retrieval metrics (port of ``hairci/eval/retrieval_metrics.py``, which
imports no JAX; the port keeps its own copy) -- Recall@K and mAP@K of the
reference's DualViewHair ``quantitative_eval.py:161-236``:

  Recall@K = fraction of queries with ≥1 ground-truth in the top-K,
  AP@K     = Σ precision@hit / min(|GT|, K), averaged over queries,

plus the top-100 result JSON in the schema the Visualizer consumes
(`{"query": ..., "top100": [...]}`).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence


def recall_map_at_k(
    retrieved: Sequence[Sequence[str]],   # per-query ranked result names
    ground_truths: Sequence[Sequence[str]],
    ks: Sequence[int] = (10, 20, 50),
) -> Dict[str, Dict[int, float]]:
    recall_at_k = defaultdict(int)
    ap_at_k = defaultdict(list)
    total = 0
    for preds, gt_list in zip(retrieved, ground_truths):
        gt = set(gt_list)
        for k in ks:
            top_k = list(preds[:k])
            if any(p in gt for p in top_k):
                recall_at_k[k] += 1
            hits, sum_prec = 0, 0.0
            for i, p in enumerate(top_k):
                if p in gt:
                    hits += 1
                    sum_prec += hits / (i + 1)
            ap = sum_prec / min(len(gt_list), k) if gt_list else 0.0
            ap_at_k[k].append(ap)
        total += 1
    return {
        "mAP": {k: (sum(ap_at_k[k]) / len(ap_at_k[k]) if ap_at_k[k] else 0.0)
                for k in ks},
        "Recall": {k: (recall_at_k[k] / total if total else 0.0) for k in ks},
        "total_queries": total,
    }


def save_top100_results(queries: Sequence[str],
                        retrieved: Sequence[Sequence[str]],
                        out_path: str) -> str:
    """Visualizer-schema dump (`quantitative_eval.py:214-218`)."""
    results = [
        {"query": os.path.basename(q),
         "top100": [os.path.basename(p) for p in preds[:100]]}
        for q, preds in zip(queries, retrieved)
    ]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return out_path


def load_benchmark(path: str) -> List[Dict]:
    """Benchmark JSON: [{"query_image": ..., "ground_truth": [...]}]
    (format-normalizing like `Visualizer/app/models/data_loader.py:28`)."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for item in data:
        query = item.get("query_image") or item.get("query_id") or item.get("query")
        gt = item.get("ground_truth") or item.get("ground_truths") or []
        out.append({"query_image": query, "ground_truth": gt})
    return out
