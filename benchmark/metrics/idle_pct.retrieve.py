"""Share of the traced window in which no operation ran on the card, in %:
one minus the union of the device intervals over the window."""


def read(rec):
    if rec["kind"] != "retrieve" or "trace" not in rec:
        return None
    busy = rec["trace"].busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / rec["trace_window_s"])
