"""Host time of dispatching the encoder in ``extract_features`` (span
``embed.forward``: normalise, the ViT, the L2 norm), the mean over the
traced window's requests, in ms."""

from harness import spans


def read(rec):
    return spans.mean(rec, "embed.forward", "host_ms")
