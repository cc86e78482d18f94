"""ak_launches.build: kernel H (approx_min_k) launches a bulk build, from the
port's own counter `ops/approx_topk.py:approx_min_k.launches`."""
UNIT = "launches"


def read(rec):
    if rec["loop"] != "build" or not rec["builds"]["launches"]:
        return None
    n = rec["builds"]["launches"]
    return sum(n) / len(n)
