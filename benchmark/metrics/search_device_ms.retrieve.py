"""Stream time of ``GalleryIndex.search`` (span ``search``: the queries'
copy in, the top-k, the copy back), the mean over the traced window's
requests, in ms."""

from harness import spans


def read(rec):
    return spans.mean(rec, "search", "stream_ms")
