"""Cached benchmark/result loading — parity with
the reference's `Visualizer/app/models/data_manager.py:115-163`
(`DataManager`, `get_benchmark`, `reload_data`).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from hairci_torch.serve.visualizer import data_loader
from hairci_torch.serve.visualizer.datasets import default_datasets, discover_models

log = logging.getLogger(__name__)


class DataManager:
    def __init__(self, datasets: Optional[Dict[str, dict]] = None,
                 data_root: str = "data"):
        self.datasets = datasets or default_datasets(data_root)
        self._benchmarks: Dict[str, Dict[str, List[str]]] = {}
        self._results: Dict[str, Dict[str, Dict[str, List[str]]]] = {}
        self.reload_data()

    def reload_data(self) -> None:
        self._benchmarks.clear()
        self._results.clear()
        import os

        for name, cfg in self.datasets.items():
            try:
                if os.path.exists(cfg["benchmark"]):
                    self._benchmarks[name] = data_loader.load_benchmark(
                        cfg["benchmark"])
            except Exception as e:  # noqa: BLE001
                log.warning("benchmark %s failed to load: %s", name, e)
            self._results[name] = {}
            for model in discover_models(cfg["results_dir"]):
                path = f"{cfg['results_dir']}/{model}_top100_results.json"
                try:
                    self._results[name][model] = data_loader.load_results(path)
                except Exception as e:  # noqa: BLE001
                    log.warning("results %s/%s failed: %s", name, model, e)

    # ------------------------------------------------------------------
    def benchmarks(self) -> List[str]:
        return sorted(self._benchmarks)

    def get_benchmark(self, dataset: str) -> Dict[str, List[str]]:
        return self._benchmarks.get(dataset, {})

    def models(self, dataset: str) -> List[str]:
        return sorted(self._results.get(dataset, {}))

    def get_results(self, dataset: str, model: str) -> Dict[str, List[str]]:
        return self._results.get(dataset, {}).get(model, {})

    def queries(self, dataset: str) -> List[str]:
        return sorted(self.get_benchmark(dataset))
