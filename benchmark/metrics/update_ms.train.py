"""Stream time of the SHAM step's update (span ``sham.update``: the
EMA update at the step's start, then the gradients' all-reduce, the
clip, AdamW and the margin statistics) per traced step, in ms."""

from harness import spans


def read(rec):
    return spans.per_step(rec, "sham.update")
