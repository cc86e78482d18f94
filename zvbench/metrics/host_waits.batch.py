"""host_waits.batch: the times the host waited for the device in one search,
from the program's own counters (zvdb_tpu_torch/utils/profiling.py): the
waits made inside the engine's search calls (`host_waits`, keyed by call
and site) over those calls (`entry_calls`), every search of the run (its
warm-up searches have the window's shape). None where the program keeps no
such counters, or where the traced sub-window saw no device work (a CPU run
waits for no device)."""
import sys

UNIT = "waits"
CALLS = ("cagra.search", "ivf.search")


def read(rec):
    prof = rec.get("profile")
    if rec["loop"] != "closed" or not prof or prof["busy_s"] <= 0:
        return None
    prog = sys.modules.get("zvdb_tpu_torch.utils.profiling")
    calls, waits = getattr(prog, "entry_calls", None), getattr(prog, "host_waits", None)
    if calls is None or waits is None:
        return None
    n = sum(calls[c] for c in CALLS)
    return sum(v for (c, _), v in waits.items() if c in CALLS) / n if n else None
