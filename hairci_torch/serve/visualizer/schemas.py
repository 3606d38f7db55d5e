"""Pydantic schemas — parity with
the reference's `Visualizer/app/schemas/retrieval.py:4-31`."""

from __future__ import annotations

from typing import Dict, List, Optional

from pydantic import BaseModel


class ImagePair(BaseModel):
    image: str
    hit: bool
    rank: int


class ModelResult(BaseModel):
    model: str
    results: List[ImagePair]
    hits: int
    misses: int


class QueryResult(BaseModel):
    query: str
    ground_truth: List[str]
    models: List[ModelResult]


class HealthStatus(BaseModel):
    status: str = "ok"
    benchmarks: int = 0
    models: int = 0
