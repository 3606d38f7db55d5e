"""Experiments (port of hairci.experiments): DualViewHair."""
