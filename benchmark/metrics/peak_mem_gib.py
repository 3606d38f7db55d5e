"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB:
what caps the batch a user can train."""


def read(rec):
    if rec["kind"] != "train" or not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 2 ** 30
