"""The 95th percentile, over every request of the window, of the time from
a request's send to its scores and indices back on the host."""

from harness.stats import percentile


def read(rec):
    if rec["kind"] != "retrieve" or not rec["latency_ms"]:
        return None
    return percentile(rec["latency_ms"], 95)
