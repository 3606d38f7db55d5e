"""Command-line entry points (port of hairci.cli)."""
