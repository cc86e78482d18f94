"""idle_pct.batch: share of the profiled sub-window in which no kernel or copy
ran on the device (the union of torch.profiler's device intervals)."""
UNIT = "%"


def read(rec):
    prof = rec.get("profile")
    if rec["loop"] != "closed" or not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
