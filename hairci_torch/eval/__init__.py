"""Feature helpers (port of hairci.eval)."""
