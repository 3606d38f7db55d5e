"""Training: optimizer, state, engine, checkpoints (port of hairci.train)."""
