#!/usr/bin/env python3
"""Time tile shapes of kernels E and F on their tensor-core routes on one GPU.

    python3 topk_tile_sweep.py                # the variants in VARIANTS
    python3 topk_tile_sweep.py 1,2 2,2        # E: chosen MQ,NJ pairs
    python3 topk_tile_sweep.py 1,2,1          # E with a diagnostic: 1 skips the mmas,
                                              # 2 the copies (wrong results, not checked)
    python3 topk_tile_sweep.py F:4,0,0        # F: MQ,HEAD,PARTS (0: the default)
    python3 topk_tile_sweep.py F:4,0,0,3      # F with a diagnostic: 3 times the copies
                                              # alone (no lists, so no mmas either); 5
                                              # runs as 0 with its counts replaced by
                                              # cycles per phase (csrc header)

For E, MQ is the m16 query tiles of a block (16 * MQ queries), NJ the n8
column tiles of a warp (128 / (8 * NJ) warps a block). For F, MQ is the
m16 query tiles of a block of its pairs pass (B > 16), HEAD a list's
headroom in entries and PARTS the blocks along the chunks per query tile.
Builds csrc/scan_topk_mma.cu once per variant (nvcc -DZVDB_TOPK_MQ=<MQ>
-DZVDB_TOPK_NJ=<NJ> or -DZVDB_TOPK2_MQ=<MQ> -DZVDB_TOPK2_HEAD=<HEAD>
-DZVDB_TOPK2_PARTS=<PARTS>, with -DZVDB_TOPK_DIAG=<diagnostic>, all at
once, into build/kernels/) and a copy of csrc/scan_topk.cu whose kernel E
runs no rounds (its scorer alone), prints ptxas's registers and spills,
holds every variant without a diagnostic against the CUDA-core kernel (E or
F) with torch.equal on ragged shapes, then times each on chip_smoke.py's
workload (the synthetic clustered corpus and its queries, N=1M, D=128,
k=10, chunk=2048) with CUDA events: E's variants at B=2048 (100 calls, with
the filter's counts), F's at B=2048 and B=128 (20 calls each: the whole
kernel, its pairs pass and its filter and select passes alone, with the
filter's counts), the CUDA-core E (10 calls) and its scorer alone (10), and
the CUDA-core F (5 calls at each batch). The engines never run it. Without a
CUDA device it exits 1.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

VARIANTS = ["1,2", "F:4,0,0", "F:2,0,0", "F:1,0,0", "F:4,32,0", "F:4,128,0", "F:4,0,2",
            "F:4,0,0,3", "F:4,0,0,5"]
ROUNDS = "      for (int r = 0; r < k; ++r) {\n        float m;\n        int am;\n"
CASES = [  # (B, N, D, k, metric, chunk)
    (37, 5000, 128, 10, "l2", 2048), (70, 5003, 40, 100, "dot", 256),
    (17, 3000, 33, 1, "l2", 256), (130, 9000, 64, 100, "l2", 4096)]


def build(name: str, src_name: str, text: str, symbol: str, flags=()):
    """nvcc `text` into build/kernels/ and return (entry point, ptxas lines)."""
    from zvdb_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / f"sweep_{name}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({src_name}):\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, symbol)
    if symbol == "zvdb_flat_topk_v2_mma":
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
    else:
        nptr = 6 if symbol.endswith("_mma") else 4
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if symbol.endswith("_mma"):
        fn.scratch_bytes = getattr(dll, symbol + "_scratch")
        fn.scratch_bytes.argtypes = [ctypes.c_int] * 5
        fn.scratch_bytes.restype = ctypes.c_longlong
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from zvdb_tpu_torch.ops import scan_topk as ST

    specs = sys.argv[1:] or VARIANTS
    ctx = CS.Ctx(False)
    CS.phase_device(ctx)
    csrc = os.path.join(ROOT, "zvdb_tpu_torch", "csrc")
    with open(os.path.join(csrc, "scan_topk_mma.cu")) as f:
        mma_src = f.read()
    with open(os.path.join(csrc, "scan_topk.cu")) as f:
        old_src = f.read()
    if old_src.count(ROUNDS) != 1:
        raise RuntimeError("scan_topk.cu's kernel E rounds moved: update ROUNDS")
    scorer_src = old_src.replace(ROUNDS, ROUNDS.replace("r < k", "r < 0"))
    with ThreadPoolExecutor(len(specs) + 1) as pool:
        futs = {}
        for spec in specs:
            if spec.startswith("F:"):
                mq, head, parts, diag = (spec[2:].split(",") + ["0"])[:4]
                name = f"F_mq{mq}_head{head}_parts{parts}" + (f"_diag{diag}" if diag != "0" else "")
                futs[name] = pool.submit(build, name, "scan_topk_mma.cu", mma_src,
                                         "zvdb_flat_topk_v2_mma",
                                         [f"-DZVDB_TOPK2_MQ={mq}", f"-DZVDB_TOPK2_HEAD={head}",
                                          f"-DZVDB_TOPK2_PARTS={parts}",
                                          f"-DZVDB_TOPK_DIAG={diag}"])
                continue
            mq, nj, diag = (spec.split(",") + ["0"])[:3]
            name = f"mq{mq}_nj{nj}" + (f"_diag{diag}" if diag != "0" else "")
            futs[name] = pool.submit(build, name, "scan_topk_mma.cu", mma_src,
                                     "zvdb_flat_topk_v1_mma",
                                     [f"-DZVDB_TOPK_MQ={mq}", f"-DZVDB_TOPK_NJ={nj}",
                                      f"-DZVDB_TOPK_DIAG={diag}"])
        futs["scorer"] = pool.submit(build, "scorer", "scan_topk.cu", scorer_src,
                                     "zvdb_flat_topk_v1")
        fns = {}
        for name, fut in futs.items():
            fns[name], ptxas = fut.result()
            print(f"variant {name}")
            for ln in ptxas:
                print("  ptxas:", ln)
    old = ST.build_v1()
    old_f = ST.build_v2_passes()
    scorer = fns.pop("scorer")
    f_fns = {name: fns.pop(name) for name in list(fns) if name.startswith("F_")}

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for b, n, d, k, metric, chunk in CASES:
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        ws, wi = ST.launch(old, q, x, k, metric, chunk)
        for name, fn in fns.items():
            if "diag" in name:
                continue
            ks, ki = ST.launch(fn, q, x, k, metric, chunk)
            ctx.sync()
            if not (torch.equal(ks, ws) and torch.equal(ki, wi)):
                raise AssertionError(f"{name} B={b} N={n} D={d} k={k} {metric} chunk={chunk}: "
                                     "differs from the CUDA-core kernel E")
        gs, gi, _, _ = ST.launch_f_passes(old_f, q, x, k, metric, chunk)
        for name, fn in f_fns.items():
            if "diag" in name:
                continue
            ks, ki, _, _ = ST.launch_f_passes(fn, q, x, k, metric, chunk)
            ctx.sync()
            if not (torch.equal(ks, gs) and torch.equal(ki, gi)):
                raise AssertionError(f"{name} B={b} N={n} D={d} k={k} {metric} chunk={chunk}: "
                                     "differs from the CUDA-core kernel F")
    print(f"  every variant equals the CUDA-core kernel (E or F) on {len(CASES)} shapes",
          flush=True)

    x1, q1 = CS.make_workload(ctx)
    xd = torch.from_numpy(x1).to(dev)
    q0 = torch.from_numpy(q1[:CS.BATCH]).to(dev)
    del x1, q1
    shape = f"B={q0.shape[0]} N={xd.shape[0]} D={xd.shape[1]} k=10 chunk=2048"
    for name, fn in fns.items():
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        ST.launch(fn, q0, xd, CS.K, stats=stats)
        st = dict(zip(ST._STATS, stats.tolist()))
        ms = ctx.time_ms(lambda fn=fn: ST.launch(fn, q0, xd, CS.K), reps=100, warmup=2)
        ctx.report(f"sweep {name} ms ({shape}, 100 calls)", ms)
        ctx.report(f"sweep {name} filter counts (one call)", st)
    for b in (CS.BATCH, 128):
        qb = q0[:b]
        fshape = f"B={b} N={xd.shape[0]} D={xd.shape[1]} k=10 chunk=2048"
        for name, fn in f_fns.items():
            stats = torch.zeros(5, dtype=torch.int64, device=dev)
            _, _, pairs, scratch = ST.launch_f_passes(fn, qb, xd, CS.K, stats=stats)
            st = dict(zip(ST._STATS_F, stats.tolist()))
            ms = ctx.time_ms(lambda fn=fn: ST.launch_f_passes(fn, qb, xd, CS.K, pairs=pairs,
                                                              scratch=scratch), reps=20)
            part = {name_: ctx.time_ms(lambda fn=fn, p_=p_: ST.launch_f_passes(
                fn, qb, xd, CS.K, passes=p_, pairs=pairs, scratch=scratch), reps=20)
                for name_, p_ in (("pairs", ST.PAIRS), ("filter", ST.FILTER),
                                  ("select", ST.SELECT))}
            ctx.report(f"sweep {name} ms ({fshape}, 20 calls; its pairs pass, filter and "
                       "select passes alone)",
                       f"{ms} ({part['pairs']}, {part['filter']}, {part['select']})")
            ctx.report(f"sweep {name} filter counts at B={b} (one call)", st)
        ctx.report(f"sweep CUDA-core kernel F ms ({fshape}, 5 calls)",
                   ctx.time_ms(lambda: ST.launch_f_passes(old_f, qb, xd, CS.K), reps=5))
    ctx.report(f"sweep CUDA-core kernel E ms ({shape}, 10 calls)",
               ctx.time_ms(lambda: ST.launch(old, q0, xd, CS.K), reps=10))
    ctx.report(f"sweep CUDA-core kernel E scorer alone (no rounds) ms ({shape}, 10 calls)",
               ctx.time_ms(lambda: ST.launch(scorer, q0, xd, CS.K), reps=10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
