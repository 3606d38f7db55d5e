"""Mean time of ``GalleryIndex.search`` (embeddings in, top-k scores and
indices back on the host) over the traced window's requests, by the
benchmark's own span around the call."""


def read(rec):
    if rec["kind"] != "retrieve" or not rec.get("traced"):
        return None
    return sum(q["search_ms"] for q in rec["traced"]) / len(rec["traced"])
