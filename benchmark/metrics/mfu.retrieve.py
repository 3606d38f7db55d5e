"""Analytic ViT forward FLOPs of the images the traced window answered,
over its seconds, against the bf16 dense peak, in %."""

from harness import peaks
from reference import vit


def read(rec):
    if rec["kind"] != "retrieve" or "trace" not in rec \
            or not rec.get("traced_images"):
        return None
    cfg = rec["config"]
    f = vit.forward_flops(cfg["model"]["arch"], cfg["img_size"])["total"]
    rate = f * rec["traced_images"] / rec["trace_window_s"]
    return 100.0 * rate / peaks.BF16_FLOPS
