"""Stream time of the SHAM step's forward (span ``sham.forward``: the
negatives' lookup and gather, the online forward of 3B rows, the EMA
forward of the masked positives, the losses) per traced step, in ms."""

from harness import spans


def read(rec):
    return spans.per_step(rec, "sham.forward")
