"""Models (port of hairci.models)."""
