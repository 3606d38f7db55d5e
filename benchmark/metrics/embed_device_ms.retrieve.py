"""Stream time of the encoder's forward in ``extract_features`` (span
``embed.forward``: normalise, the ViT, L2 norm), the mean over the traced
window's requests, in ms: from an event recorded before the forward's
first launch to one after its last. It is bounded below by the host's
dispatch of the forward (``embed_launch_ms.retrieve``): where the card
runs each kernel faster than the host launches the next (Q = 16 and 32
in this cell) it reads that dispatch, and it reads the ViT's kernels only
where they outlast it. Either way it is the model layer's time: fewer
launches or faster kernels move it."""

from harness import spans


def read(rec):
    return spans.mean(rec, "embed.forward", "stream_ms")
