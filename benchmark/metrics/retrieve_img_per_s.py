"""Query images answered in the window over the window's seconds."""


def read(rec):
    if rec["kind"] != "retrieve":
        return None
    return rec["images"] / rec["window_s"]
