"""Small utilities (device resolution)."""
