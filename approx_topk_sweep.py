#!/usr/bin/env python3
"""Time kernel H (approx_min_k) and variants of its source at the sites' operands on one GPU.

    python3 approx_topk_sweep.py                     # the variants in VARIANTS
    python3 approx_topk_sweep.py "" FOLD_LOADS=16 ROW_THREADS=64,MIN_BLOCKS=5

A variant is a comma-separated list of NAME=VALUE patches (PATCHES) applied
to a copy of zvdb_tpu_torch/csrc/approx_topk.cu written under
build/kernels/; "" is the source as it is. BLOCK_THREADS, FOLD_LOADS and
MIN_BLOCKS set the source's constant of that name, ROW_THREADS fixes the
threads a row in place of row_threads' rule, and PHASES=1 or PHASES=2 makes
the one-launch kernel run its fold alone or its select alone (keys made from
the bin index), which computes no result and is not held against the plain
version. The variants are built all at once with ptxas's registers and
spills printed, and each (but a PHASES one) is held to the plain version
(positions and value bits) over chip_smoke.py phase 40's grids and at the
eight site operands. Then, at each site operand (seeded normal scores,
every 97th column +inf, as phase 40 makes them), it prints the byte bound,
each variant's entry point alone (outputs made beforehand), the wrapper and
torch.topk (CUDA events over 20 calls), torch.profiler's device time by
kernel for the first variant, and the host us a call of the wrapper's parts
(perf_counter over 500 calls). The last line is the JSON of every time.
Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

VARIANTS = ["", "MIN_BLOCKS=5", "MIN_BLOCKS=6", "MIN_BLOCKS=8", "ROW_THREADS=64",
            "ROW_THREADS=128", "FOLD_LOADS=16", "PHASES=1", "PHASES=2"]

FOLD_CALL = "  fold_row(r, 0, n, L, gl, G, sl.keys);\n"
SELECT_CALL = ("  select_row<G>(sl.keys, sl.hist, *sl.st, L, k, sort_max, r, vals + row * k, "
               "pos + row * k, gl,\n                gid);\n")
PATCHES = {
    "BLOCK_THREADS": lambda v: ("constexpr int BLOCK_THREADS = 128;",
                                f"constexpr int BLOCK_THREADS = {v};"),
    "FOLD_LOADS": lambda v: ("constexpr int FOLD_LOADS = 8;", f"constexpr int FOLD_LOADS = {v};"),
    "MIN_BLOCKS": lambda v: ("constexpr int MIN_BLOCKS = 4;", f"constexpr int MIN_BLOCKS = {v};"),
    "ROW_THREADS": lambda v: ("int row_threads(int L, long long windows) {\n",
                              f"int row_threads(int L, long long windows) {{\n  return {v};\n"),
    "PHASES": lambda v: {
        "1": (SELECT_CALL, "  row_sync<G>(gid);\n  for (int i = gl; i < k; i += G) "
                           "pos[row * k + i] = static_cast<long long>(sl.keys[i] >> 32);\n"),
        "2": (FOLD_CALL, "  for (int b = gl; b < L; b += G)\n    sl.keys[b] = make_key("
                         "static_cast<float>((b * 40503u) & 1023), b);\n")}[v],
}


def build(spec: str):
    """The source patched by `spec`, nvcc'd under build/kernels/: (name, its
    entry point, ptxas's register and spill lines)."""
    from zvdb_tpu_torch.ops import approx_topk as AK
    from zvdb_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "approx_topk.cu").read_text()
    sets = [kv.split("=") for kv in spec.split(",") if kv]
    for key, value in sets:
        old, new = PATCHES[key](value)
        if src.count(old) != 1:
            raise RuntimeError(f"approx_topk.cu changed: {key}'s patch no longer applies")
        src = src.replace(old, new)
    name = "_".join(k + v for k, v in sets).lower() or "source"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / f"approx_sweep_{name}.cu"
    path.write_text(src)
    lib = path.with_suffix(".so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    fn = ctypes.CDLL(str(lib)).zvdb_approx_min_k
    fn.argtypes = AK._ARGTYPES
    fn.restype = ctypes.c_int
    return name, fn, ptxas


def host_costs(fn, s, k, r):
    """Host us a call (perf_counter over 500 calls, no sync inside) of the
    wrapper's parts: the raw stream, the two output allocations, L and the
    route, the ctypes call refused at once (rows = 0), the entry point with
    its launch, and the whole wrapper."""
    import chip_smoke as CS
    from zvdb_tpu_torch.ops import approx_topk as AK

    n, rows = s.shape[-1], s.numel() // s.shape[-1]
    parts = {
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(s.device.index),
        "two new_empty": lambda: (s.new_empty((rows, k)),
                                  s.new_empty((rows, k), dtype=torch.int64)),
        "reduction_output_size + fold_splits": lambda: AK.fold_splits(
            rows, -(-n // AK.reduction_output_size(n, s.dim(), k, r))),
        "ctypes call refused": lambda: fn(0, None, 0, 0, 0, 0, 0, 0, 0, 0, None),
        "entry point": CS.approx_entry_call(s, k, r, fn),
        "wrapper": lambda: AK.approx_min_k(s, k, recall_target=r),
    }
    out = {}
    for name, part in parts.items():
        part()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            part()
        out[name] = round((time.perf_counter() - t0) / 500 * 1e6, 2)
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=VARIANTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("approx_topk_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from zvdb_tpu_torch.ops import approx_topk as AK

    ctx = CS.Ctx(False)
    CS.phase_device(ctx)
    fns = {}
    with ThreadPoolExecutor(len(args.variants)) as pool:
        for name, fn, ptxas in pool.map(build, args.variants):
            fns[name] = fn
            print(f"variant {name}")
            for ln in ptxas:
                print("  ptxas:", ln)
    held = {name: fn for name, fn in fns.items() if "phases" not in name}
    dev = torch.device("cuda")
    grid = ([(CS._approx_tie_rows(shape, i), k, r) for i, (shape, k, r) in
             enumerate(CS.APPROX_GRID)]
            + [(CS._approx_rows(kind, shape, k), k, r) for kind, shape, k, r in
               CS.APPROX_TIE_GRID])
    for name, fn in held.items():
        for rows, k, r in grid:
            s = torch.from_numpy(rows).to(dev)
            CS.approx_case(ctx, name, s, k, r, run=CS.approx_entry_call(s, k, r, fn))

    gen = torch.Generator(device=dev).manual_seed(40)
    first = next(iter(fns))
    res = {"card": ctx.card}
    for label, shape, k, r in CS.APPROX_SITES_AT_SIZE:
        s = torch.randn(shape, generator=gen, device=dev)
        s.view(-1, shape[-1])[:, ::97] = float("inf")
        rows = math.prod(shape[:-1])
        bound = (s.numel() * 4 + rows * k * 12) / CS.HBM_BYTES_S * 1e3
        row = {"shape": list(shape), "k": k,
               "L": AK.reduction_output_size(shape[-1], len(shape), k, r), "bound_ms": bound}
        for name, fn in fns.items():
            if name in held:
                CS.approx_case(ctx, f"{label} {name}", s, k, r,
                               run=CS.approx_entry_call(s, k, r, fn))
            row[f"{name} entry"] = CS.approx_entry_ms(ctx, s, k, r, fn=fn)
        row["wrapper"] = ctx.time_ms(lambda: AK.approx_min_k(s, k, recall_target=r), reps=20,
                                     warmup=2)
        row["torch.topk"] = ctx.time_ms(lambda: torch.topk(s, k, dim=-1, largest=False),
                                        reps=10)
        by_name = CS.profile_calls(ctx, f"{label} {first} entry point profile (10 calls)",
                                   [CS.approx_entry_call(s, k, r, fns[first])] * 10, "call")
        row[f"{first} device us by kernel (10 calls)"] = by_name
        row["host us a call"] = host_costs(fns[first], s, k, r)
        print(f"site {label} {tuple(shape)} k={k} L={row['L']}: bound {bound:.4f} ms  "
              f"[{ctx.card}]", flush=True)
        for key, v in row.items():
            if isinstance(v, float) and key != "bound_ms":
                print(f"  {key}: {v:.4f} ms ({bound / v:.1%} of the bound)", flush=True)
            elif isinstance(v, dict):
                print(f"  {key}: {v}", flush=True)
        res[label] = row
        del s
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
