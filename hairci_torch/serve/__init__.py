"""Serving (port of ``hairci.serve``): the retrieval HTTP API (``api``),
the segment -> embed -> retrieve demo (``demo``) and the result visualizer
(``visualizer``). Nothing is imported here: the visualizer needs pydantic,
which ``api`` and ``demo`` do not."""
