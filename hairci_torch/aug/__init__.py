"""Batched preprocessing on tensors (port of hairci.aug)."""
