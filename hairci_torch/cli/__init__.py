"""Command-line entry points (port of hairci.cli): ``retrieval``,
``mainpretrain`` (SHAM) and ``knn_classification`` (SHAM, kNN)."""
