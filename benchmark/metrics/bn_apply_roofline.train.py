"""The BatchNorm apply kernel (``bn_apply_kernel`` of
``hairci_torch/ops/csrc/bn_apply.cu``) against its roofline, in %: the least
time its traffic in the traced steps could take at the card's memory rate,
over the kernel's device time.

Each step normalises every trunk BN input of the online forward over 3B
rows in train mode and of the EMA teacher's forward over B rows in eval
mode, once each. The bytes are a floor: one read of the input and one write
of the output, each in the compute dtype; the residual read of a block's
last BN, the f32 vectors a channel and the statistics are left out, so no
reading can pass 100 %. A step without the kernel reads nothing: the metric
is then left out."""

from harness import peaks
from reference import resnet

KERNEL = "bn_apply_kernel"


def step_bytes(cfg, batch: int) -> float:
    model, img = cfg["model"], cfg["img_size"]
    if model["kind"] != "resnet":
        return 0.0
    elem = 2 if cfg["dtype"] in ("bfloat16", "float16") else 4
    inputs = (resnet.bn_inputs(model["arch"], 3 * batch, img)
              + resnet.bn_inputs(model["arch"], batch, img))
    return float(sum(2 * m * c * elem for m, c in inputs))


def read(rec):
    if rec["kind"] != "train" or "trace" not in rec:
        return None
    t = rec["trace"].kernel_s(KERNEL)
    b = step_bytes(rec["config"], rec["traffic"]["batch"])
    if t <= 0 or b <= 0:
        return None
    return 100.0 * rec["trace_steps"] * b / peaks.HBM_BYTES / t
