"""The BatchNorm backward's two kernels (``bn_grad_sums_kernel`` and
``bn_grad_input_kernel`` of ``hairci_torch/ops/csrc/bn_apply.cu``) together
against their roofline, in %: the least time their traffic in the traced
steps could take at the card's memory rate, over the two kernels' device
time.

Each step differentiates every trunk BN of the online forward over 3B rows
once. The bytes are a floor: the sums' pass reads dy and x, the input
gradient's pass reads dy and x and writes dx, each in the compute dtype;
the ReLU output read for the mask, the residual's gradient written at a
block's end, the f32 vectors a channel and the partial sums are left out,
so no reading can pass 100 %. A step without the kernels reads nothing:
the metric is then left out."""

from harness import peaks
from reference import resnet

# both kernels' names hold it, and no other kernel's does
KERNELS = "bn_grad_"


def step_bytes(cfg, batch: int) -> float:
    model, img = cfg["model"], cfg["img_size"]
    if model["kind"] != "resnet":
        return 0.0
    elem = 2 if cfg["dtype"] in ("bfloat16", "float16") else 4
    inputs = resnet.bn_inputs(model["arch"], 3 * batch, img)
    return float(sum(5 * m * c * elem for m, c in inputs))


def read(rec):
    if rec["kind"] != "train" or "trace" not in rec:
        return None
    t = rec["trace"].kernel_s(KERNELS)
    b = step_bytes(rec["config"], rec["traffic"]["batch"])
    if t <= 0 or b <= 0:
        return None
    return 100.0 * rec["trace_steps"] * b / peaks.HBM_BYTES / t
