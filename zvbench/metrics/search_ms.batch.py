"""search_ms.batch: mean ms of an engine's search call in a closed loop,
each span ending in a device sync (the traced run's first half)."""
UNIT = "ms"


def read(rec):
    spans = rec["spans"].get("search")
    if rec["loop"] != "closed" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
