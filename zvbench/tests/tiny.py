"""Tiny cells for the CPU tests: the shipped cells' files with the data, the
index and the mix cut to a few thousand rows, written as files of their own."""
import copy
import json
from pathlib import Path

from zvbench import harness as H

TINY_DATA = dict(n=3000, queries=256, n_clusters=30)
TINY_CONFIG = {"CagraIndex": dict(n_anchors=512, block=256, kmeans_sample=3000),
               "IVFIndex": dict(n_clusters=128)}
TINY_TRAFFIC = {
    "closed": dict(batch=64, warm=1, profile_s=0.2),
    "build": dict(search_batch=128, edge_sample=128, profile_s=0.3),
}


def tiny_cell(name: str) -> dict:
    """A shipped cell, cut to the tiny size (a dict, as load_cell gives)."""
    cell = copy.deepcopy(H.load_cell(name))
    cell["config"]["data"].update(TINY_DATA)
    cell["config"]["config"].update(TINY_CONFIG[cell["config"]["engine"]])
    cell["traffic"].update(TINY_TRAFFIC[cell["traffic"]["loop"]])
    return cell


def write_cell(root: Path, name: str, cell: dict) -> Path:
    """The cell as three files under `root`, named as the harness finds them."""
    w = cell["workload"]
    for sub, fname, body in (("workloads", name, w), ("configs", w["config"], cell["config"]),
                             ("traffic", w["traffic"], cell["traffic"])):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / f"{fname}.json").write_text(json.dumps(body, indent=1))
    return root
