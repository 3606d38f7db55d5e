"""Mean time of ``HairEncoder.extract_features`` (uint8 crops in, unit
embeddings back on the host) over the traced window's requests, by the
benchmark's own span around the call."""


def read(rec):
    if rec["kind"] != "retrieve" or not rec.get("traced"):
        return None
    return sum(q["embed_ms"] for q in rec["traced"]) / len(rec["traced"])
