"""The bn_stats kernel (``hairci_torch/ops/csrc/bn_stats.cu``) against its
roofline, in %: the least time its reads of the traced steps' BN inputs
could take at the card's memory rate, over the kernel's device time.

Each step normalises every trunk BN input and the two head BN inputs of the
online forward over 3B rows, once each (the EMA's forwards are in eval
mode); each input is read once in the compute dtype and two f32 vectors a
channel are written."""

from harness import peaks
from reference import resnet

KERNEL = "bn_stats_kernel"


def step_bytes(cfg, batch: int) -> float:
    model, img = cfg["model"], cfg["img_size"]
    rows = 3 * batch
    elem = 2 if cfg["dtype"] in ("bfloat16", "float16") else 4
    inputs = []
    if model["kind"] == "resnet":
        inputs += resnet.bn_inputs(model["arch"], rows, img)
    inputs += [(rows, c) for c in model["proj"]]
    return float(sum(m * c * elem + 2 * c * 4 for m, c in inputs))


def read(rec):
    if rec["kind"] != "train" or "trace" not in rec:
        return None
    t = rec["trace"].kernel_s(KERNEL)
    if t <= 0:
        return None
    b = step_bytes(rec["config"], rec["traffic"]["batch"])
    return 100.0 * rec["trace_steps"] * b / peaks.HBM_BYTES / t
