"""Host time of the embeddings' copy back in ``extract_features``
(span ``embed.copy_out``, which waits for the forward), the mean over the
traced window's requests, in ms."""

from harness import spans


def read(rec):
    return spans.mean(rec, "embed.copy_out", "host_ms")
