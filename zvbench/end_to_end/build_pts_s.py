"""build_pts_s: rows of every build in the window over the time from the
first build's start to the last build's end."""
UNIT = "rows/s"


def read(rec):
    if rec["loop"] != "build":
        return None
    return sum(rec["builds"]["rows"]) / rec["window_s"]
