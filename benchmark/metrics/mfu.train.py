"""Model FLOPs of the traced window's SHAM steps (no recomputation) over
its seconds, against the bf16 dense peak, in %."""

from harness import peaks
from reference.sham import step_flops


def read(rec):
    if rec["kind"] != "train" or "trace" not in rec:
        return None
    flops = step_flops(rec["config"], rec["traffic"]["batch"])
    rate = flops * rec["trace_steps"] / rec["trace_window_s"]
    return 100.0 * rate / peaks.BF16_FLOPS
