"""Gallery index and encoders (port of hairci.retrieval)."""
