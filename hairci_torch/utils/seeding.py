"""Determinism (port of ``hairci/utils/seeding.py``): ``set_seed`` seeds
python's ``random``, numpy and torch's global generators (the reference's
``set_seed``), and returns a CPU ``torch.Generator`` seeded the same way,
the port's stand-in for the JAX package's root key. Callers that draw from
their own generators may ignore it."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
