"""qps: every query answered in a closed-loop window over the window's
seconds, from its start to the last answer's arrival on the host."""
UNIT = "queries/s"


def read(rec):
    if rec["loop"] != "closed":
        return None
    return rec["queries"] / rec["window_s"]
