"""Command-line entry points (port of hairci.cli): ``retrieval`` and
``face_retrieval``, ``mainpretrain`` and ``knn_classification``."""
