"""The gallery top-k kernel (``hairci_torch/ops/csrc/topk.cu``, both its
stages) against its roofline, in %: for each search of the traced window,
the larger of its products' operations at the tensor cores' TF32 rate
(three TF32 products make one f32 product, the kernel's split; for a bf16
gallery, three bf16 ones) and one read of the gallery and the queries and
one write of the answers at the memory's rate, over the kernels' device
time."""

from harness import peaks

KERNELS = ("topk_partial_kernel", "topk_tc_kernel", "topk_merge_kernel")


def search_bound_s(q: int, n: int, d: int, k: int,
                   gallery_bytes: int) -> float:
    flops = 3 * 2.0 * q * n * d
    rate = peaks.TF32_FLOPS if gallery_bytes == 4 else peaks.BF16_FLOPS
    moved = n * d * gallery_bytes + q * d * 4 + q * k * (4 + 8)
    return peaks.bound_s(flops, moved, rate)


def read(rec):
    if rec["kind"] != "retrieve" or "trace" not in rec \
            or not rec.get("traced"):
        return None
    t = sum(rec["trace"].kernel_s(name) for name in KERNELS)
    if t <= 0:
        return None
    cfg = rec["config"]
    n, d = cfg["serve"]["gallery_rows"], cfg["model"]["arch"]["width"]
    gb = 4 if cfg["serve"]["gallery_dtype"] == "float32" else 2
    bound = sum(search_bound_s(q["size"], n, d, rec["traffic"]["k"], gb)
                for q in rec["traced"])
    return 100.0 * bound / t
