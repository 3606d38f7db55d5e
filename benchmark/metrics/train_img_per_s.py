"""Images of every training step in the window over the window's seconds;
the window ends on a device sync."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["images"] / rec["window_s"]
