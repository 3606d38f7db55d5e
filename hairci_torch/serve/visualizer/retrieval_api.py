"""REST API core — parity with
the reference's `Visualizer/app/models/retrieval_api.py:12-134`: endpoints
benchmarks / models / model_versions / queries / result, hit computation by
ground-truth membership.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from hairci_torch.serve.visualizer.data_manager import DataManager
from hairci_torch.serve.visualizer.image_utils import ResultProcessor
from hairci_torch.serve.visualizer.schemas import (
    HealthStatus,
    ImagePair,
    ModelResult,
    QueryResult,
)


class RetrievalAPI:
    def __init__(self, manager: DataManager):
        self.manager = manager

    def health(self) -> HealthStatus:
        n_models = sum(len(self.manager.models(d))
                       for d in self.manager.benchmarks())
        return HealthStatus(status="ok",
                            benchmarks=len(self.manager.benchmarks()),
                            models=n_models)

    def benchmarks(self) -> List[str]:
        return self.manager.benchmarks()

    def models(self, dataset: str) -> List[str]:
        return self.manager.models(dataset)

    def queries(self, dataset: str) -> List[str]:
        return self.manager.queries(dataset)

    def get_query_result(self, dataset: str, query: str,
                         models: Optional[List[str]] = None,
                         top_k: int = 100) -> QueryResult:
        bench = self.manager.get_benchmark(dataset)
        gt = bench.get(query, [])
        models = (models or self.manager.models(dataset))[:2]  # ≤2 side-by-side
        model_results = []
        for m in models:
            ranked = self.manager.get_results(dataset, m).get(query, [])
            rows, hits, misses = ResultProcessor.compute_hits_and_misses(
                ranked, gt, top_k)
            model_results.append(ModelResult(
                model=m, results=[ImagePair(**r) for r in rows],
                hits=hits, misses=misses))
        return QueryResult(query=query, ground_truth=gt,
                           models=model_results)
