"""Stream time of the SHAM step's augmentation (span ``sham.augment``:
the draws and the two views, then the positives' rotation and masking)
per traced step, in ms."""

from harness import spans


def read(rec):
    return spans.per_step(rec, "sham.augment")
