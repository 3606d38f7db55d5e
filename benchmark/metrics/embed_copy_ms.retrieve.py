"""Host time of the query crops' copy to the device in
``extract_features`` (span ``embed.copy_in``), the mean over the traced
window's requests, in ms."""

from harness import spans


def read(rec):
    return spans.mean(rec, "embed.copy_in", "host_ms")
