"""Result-inspection web app (port of ``hairci/serve/visualizer``; the
reference's ``Visualizer/``): browse precomputed top-100 retrieval JSONs
against ground-truth benchmarks with hit/miss colouring, for at most two
models side by side. Needs no card.

The app's core (configuration, loading, hit computation, pydantic schemas)
needs no web framework; ``server.serve_stdlib`` serves it with the standard
library's ``ThreadingHTTPServer``, and ``server.create_fastapi_app`` gives
the same routes on FastAPI where fastapi is installed (imported there only).
"""

from hairci_torch.serve.visualizer.data_manager import DataManager
from hairci_torch.serve.visualizer.retrieval_api import RetrievalAPI
