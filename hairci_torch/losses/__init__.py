"""Losses (port of hairci.losses)."""
