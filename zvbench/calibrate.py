"""The readings that `correct`'s limits are set from, in one process:

    python3 zvbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --faults far_bins,one_hop --fault-seeds 4,5,6 --seconds 3

runs the cell (a short window at the cell's own load and sizes) on each seed
with the program, then on each control seed with the plain reference in the
program's place at the configuration's control precision, then on each
fault seed with each named fault planted in the program between set-up and
the window, and prints one JSON line a run (the compared numbers, recall,
the end-to-end metrics), then the largest reading of each number over the
program's runs and the smallest over each other side's. The benchmark's own
runs never run the control or a fault.

Faults: `far_bins` kernel H (approx_min_k) keeps the k largest bins
instead of the k smallest (CAGRA's seed selection, the build's block cuts);
`one_hop` CAGRA's beam stops after one hop; `far_probes` IVF probes the
nprobe farthest lists.
"""
import copy
import json
import sys
import time
from pathlib import Path


class _Negated:
    """A module's stand-in whose `pairwise_scores` returns the scores negated."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def pairwise_scores(self, *a, **kw):
        return -self._mod.pairwise_scores(*a, **kw)


def plant(name: str, undo: list):
    """before_window(run) that plants fault `name`; undo gains its repair."""
    def far_bins(run):
        orig = run.ak.approx_min_k

        def largest(s, k, *a, **kw):
            v, pos = orig(-s, k, *a, **kw)
            return -v, pos
        largest.launches = 0
        run.ak.approx_min_k = largest
        undo.append(lambda: setattr(run.ak, "approx_min_k", orig))

    def one_hop(run):
        run.cfg["search"]["max_iters"] = 1

    def far_probes(run):
        from zvdb_tpu_torch.index import ivf

        orig = ivf.D
        ivf.D = _Negated(orig)
        undo.append(lambda: setattr(ivf, "D", orig))

    return {"far_bins": far_bins, "one_hop": one_hop, "far_probes": far_probes}[name]


def main() -> int:
    import argparse

    import torch

    from zvbench import harness as H

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = H.load_cell(args.workload)
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    plan = [("program", None, seeds(args.seeds)),
            ("control", None, seeds(args.control_seeds))]
    plan += [(f, f, seeds(args.fault_seeds)) for f in args.faults.split(",") if f]
    seen: dict = {}
    for side, fault, side_seeds in plan:
        control = cell["config"]["control"] if side == "control" else None
        for seed in side_seeds:
            undo: list = []
            t = time.perf_counter()
            try:
                line = H.run_cell(copy.deepcopy(cell), seed, args.seconds, False, "cuda", control,
                                  before_window=plant(fault, undo) if fault else None)
            finally:
                for u in undo:
                    u()
            torch.cuda.reset_peak_memory_stats()
            vals = {k: v["value"] for k, v in line["checks"].items()}
            for k, v in vals.items():
                seen.setdefault(side, {}).setdefault(k, []).append(v)
            print(json.dumps(dict(side=side, seed=seed, correct=line["correct"], checks=vals,
                                  metrics={k: v["value"] for k, v in line["metrics"].items()},
                                  seconds=time.perf_counter() - t)), flush=True)
    out = {"program_max": {k: max(v) for k, v in seen.get("program", {}).items()}}
    for side in seen:
        if side != "program":
            out[f"{side}_min"] = {k: min(v) for k, v in seen[side].items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
