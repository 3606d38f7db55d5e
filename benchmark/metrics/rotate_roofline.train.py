"""The rotate + blur kernel (``hairci_torch/ops/csrc/rotate.cu``) against
its roofline, in %: one read and one write of the f32 positives a step
(B x S x S x 3) at the card's memory rate, over the kernel's device time."""

from harness import peaks

KERNEL = "rotate_kernel"


def read(rec):
    if rec["kind"] != "train" or "trace" not in rec:
        return None
    t = rec["trace"].kernel_s(KERNEL)
    if t <= 0:
        return None
    s = rec["config"]["img_size"]
    b = 2.0 * rec["traffic"]["batch"] * s * s * 3 * 4
    return 100.0 * rec["trace_steps"] * b / peaks.HBM_BYTES / t
