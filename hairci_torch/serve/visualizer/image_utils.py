"""Hit computation + path resolution — parity with
the reference's `Visualizer/app/utils/image_utils.py:8-90`
(`ImagePathResolver`, `ResultProcessor.compute_hits_and_misses`). A result
image hits when `img.replace('_hair.png', '.jpg')` is in the ground truth
(`retrieval_api.py:117`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple


class ImagePathResolver:
    """Maps result/ground-truth names to mounted static paths."""

    def __init__(self, mounts: Dict[str, str]):
        self.mounts = mounts

    def resolve(self, name: str) -> str:
        base = os.path.basename(name)
        if base.endswith("_hair.png") and "hair" in self.mounts:
            return os.path.join(self.mounts["hair"], base)
        for mount in self.mounts.values():
            candidate = os.path.join(mount, base)
            if os.path.exists(candidate):
                return candidate
        mount = next(iter(self.mounts.values()))
        return os.path.join(mount, base)


def to_gt_name(result_name: str) -> str:
    """`_hair.png` result → `.jpg` ground-truth key."""
    return os.path.basename(result_name).replace("_hair.png", ".jpg")


class ResultProcessor:
    @staticmethod
    def compute_hits_and_misses(
        ranked: Sequence[str], ground_truth: Sequence[str], top_k: int = 100
    ) -> Tuple[List[dict], int, int]:
        gt = {os.path.basename(g) for g in ground_truth}
        rows, hits = [], 0
        for rank, name in enumerate(list(ranked)[:top_k], 1):
            hit = to_gt_name(name) in gt or os.path.basename(name) in gt
            hits += int(hit)
            rows.append({"image": os.path.basename(name), "hit": hit,
                         "rank": rank})
        return rows, hits, len(rows) - hits
