"""approx_min_k_roofline.build: kernel H's (approx_min_k's) share of its byte bound in
the profiled sub-window: the mean bound of the calls recorded there
(roofline/approx_min_k.py) over a call's time, the sum over the kernel's
names of the mean duration of its recorded events (one event a name a
call)."""
from zvbench.roofline.approx_min_k import bound_s

UNIT = "%"


def read(rec):
    prof, calls = rec.get("profile"), rec.get("approx_calls")
    if rec["loop"] != "build" or not prof or not calls:
        return None
    per_call = sum(t / c for name, (c, t) in prof["kernels"].items()
                   if name.startswith("approx_"))
    if per_call <= 0:
        return None
    return 100.0 * sum(bound_s(*c) for c in calls) / len(calls) / per_call
