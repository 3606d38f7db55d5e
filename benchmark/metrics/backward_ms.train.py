"""Stream time of the SHAM step's backward (span ``sham.backward``:
``total.backward()``, with remat's recomputation on the ViT) per traced
step, in ms."""

from harness import spans


def read(rec):
    return spans.per_step(rec, "sham.backward")
