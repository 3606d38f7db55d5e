"""Retrieval serving API (port of hairci.serve)."""
