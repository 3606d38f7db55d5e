"""Host time of ``SHAMRecipe.train_step`` (span ``sham.step``) per traced
step, in ms: the step's time on the host clock. While the card paces the
step, as in both training cells, the host fills the card's launch queue
and then waits in the step's last launches (the last ``sham.update``) for
the card, so this reads the card's pace, B / ``train_img_per_s``, and not
the host's headroom. Where the host paces the card, it reads the host's
own time a step, and ``idle_pct.train`` rises with it."""

from harness import spans


def read(rec):
    return spans.per_step(rec, "sham.step", "host_ms")
