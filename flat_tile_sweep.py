#!/usr/bin/env python3
"""Time tile shapes of kernel A's tensor-core route on one GPU.

    python3 flat_tile_sweep.py                  # the variants in VARIANTS
    python3 flat_tile_sweep.py NAME=WQ,MT,STAGES/WQ,MT,STAGES/UNROLL ...
    python3 flat_tile_sweep.py --seeds          # CAGRA's two seed routes

Each variant rewrites the Tile constants of zvdb_tpu_torch/csrc/flat_scan_mma.cu
for "default" / "high" (warps along the queries, m16 tiles per warp, raw
corpus steps in flight) and the unroll of its k loop, builds it with nvcc for
sm_90a into build/kernels/ (all variants at once), prints ptxas's registers and
spills, and holds it against the plain version (chip_smoke.check_bins) on
ragged shapes, f32 and bf16 storage, and the duplicated-row tie probe. Then it
times "default" and "high" at B=2048, N=1M, D=128, L=1024 on a seeded normal
corpus with CUDA events (100 calls each), beside the CUDA-core kernel
(csrc/flat_scan.cu, 20 calls) and the f32 and bf16 torch.matmul yardsticks.
The engines never run it. Without a CUDA device it exits 1.

--seeds times CAGRA's two routes to its seed anchors (index/cagra.py:
seed_route) with CUDA events, 20 calls each, over B = 16 ... 2048 queries and
A = 250,000 (cagra_1m's anchors), 32,768 (a 250,000-row shard's default
anchors) and 8,192 (a 100,000-row index's) at n_seeds 16, D = 128, "high" and
"default": "approx" (the [B, A] product, then approx_min_k's kernel over it)
and "bins" (kernel A's bins, then approx_min_k's kernel over them). Beside
each pair it prints the share of equal seeds and the largest score gap;
SEED_BINS_MIN_QUERIES in index/cagra.py is read off this table.
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

# the shipped shape first, then the first design (16 warps of 32 x 32 tiles)
VARIANTS = ["shipped=4,4,2/4,2,2/4", "first=8,2,3/4,2,2/2", "q128=4,2,3/4,2,2/2"]
TILE = ("  static constexpr int WQ = 4;\n"
        "  static constexpr int MT = PREC == kDefault ? 4 : 2;\n"
        "  static constexpr int STAGES = 2;\n")
UNROLL = "#pragma unroll {}\n    for (int k = 0; k < KC; k += 16)"
CASES = [  # (B, N, D, L, metric, precision, storage)
    (37, 5000, 13, 128, "l2", "default", torch.float32),
    (37, 5000, 13, 128, "dot", "high", torch.float32),
    (37, 5000, 13, 128, "cosine", "default", torch.float32),
    (70, 4099, 128, 100, "l2", "high", torch.bfloat16),
    (70, 4099, 36, 100, "l2", "high", torch.bfloat16),
    (1, 3001, 128, 1024, "l2", "default", torch.bfloat16),
    (8, 2048, 33, 2048, "dot", "default", torch.float32),
    (300, 3000, 300, 64, "dot", "default", torch.float32),
    (5, 3000, 300, 64, "l2", "high", torch.float32),
    (2048, 200_000, 128, 1024, "l2", "default", torch.float32),
    (2048, 200_000, 128, 1024, "l2", "high", torch.float32),
]


def variant_source(src: str, spec: str) -> str:
    """The kernel source with the Tile constants and unroll of `spec`."""
    dflt, high, unroll = spec.split("/")
    (wd, md, sd), (wh, mh, sh) = ([int(v) for v in p.split(",")] for p in (dflt, high))
    if src.count(TILE) != 1 or src.count(UNROLL.format(4)) != 1:
        raise RuntimeError("flat_scan_mma.cu's Tile constants moved: update TILE and UNROLL")
    tile = (f"  static constexpr int WQ = PREC == kDefault ? {wd} : {wh};\n"
            f"  static constexpr int MT = PREC == kDefault ? {md} : {mh};\n"
            f"  static constexpr int STAGES = PREC == kDefault ? {sd} : {sh};\n")
    return src.replace(TILE, tile).replace(UNROLL.format(4), UNROLL.format(int(unroll)))


def build(name: str, text: str):
    """nvcc the variant into build/kernels/ and return its entry point."""
    from zvdb_tpu_torch.ops import cuda_build
    from zvdb_tpu_torch.ops import flat_scan as FS

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / f"sweep_{name}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).zvdb_flat_scan_bins_mma
    fn.argtypes = FS._ARGTYPES
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def seed_sweep(ctx) -> int:
    """Time the "approx" and "bins" seed routes over B and A (see --seeds)."""
    from zvdb_tpu_torch.index import cagra
    from zvdb_tpu_torch.ops import approx_topk as AK
    from zvdb_tpu_torch.ops import distance as D

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    s_count = 16
    for a in (250_000, 32_768, 8_192):
        x = torch.randn(a, 128, device=dev, generator=g)
        norms = D.sq_norms(x)
        for precision in ("high", "default"):
            for b in (16, 64, 128, 256, 512, 1024, 2048):
                q = x[:b] + 0.5 * torch.randn(b, 128, device=dev, generator=g)

                def approx():
                    return AK.approx_min_k(D.pairwise_scores(q, x, norms, "l2",
                                                             precision=precision), s_count)

                def bins():
                    return cagra._binned_seeds(q, x, norms, s_count, "l2", precision)

                (sa, ca), (sb, cb) = approx(), bins()
                same = (ca.to(torch.int32) == cb).float().mean().item()
                gap = (sa - sb).abs().max().item()
                ms_a = ctx.time_ms(approx, reps=20, warmup=2)
                ms_b = ctx.time_ms(bins, reps=20, warmup=2)
                ctx.report(f"seeds A={a} B={b} {precision} ms approx / bins",
                           f"{ms_a:.4f} / {ms_b:.4f} (bins/approx {ms_b / ms_a:.3f}; equal "
                           f"seeds {same:.4f}, largest score gap {gap:.3g})")
        del x, norms
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS

    ctx = CS.Ctx(False)
    CS.phase_device(ctx)
    if sys.argv[1:] == ["--seeds"]:
        return seed_sweep(ctx)
    specs = dict(v.split("=") for v in (sys.argv[1:] or VARIANTS))
    with open(os.path.join(ROOT, "zvdb_tpu_torch", "csrc", "flat_scan_mma.cu")) as f:
        src = f.read()
    with ThreadPoolExecutor(len(specs) + 1) as pool:
        futs = {n: pool.submit(build, n, variant_source(src, s)) for n, s in specs.items()}
        old = pool.submit(FS.build)
        fns = {}
        for n, fut in futs.items():
            fns[n], ptxas = fut.result()
            print(f"variant {n} (default / high WQ,MT,STAGES / unroll: {specs[n]})")
            for ln in ptxas:
                print("  ptxas:", ln)
        old = old.result()

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    for name, fn in fns.items():
        for b, n, d, l_bins, metric, precision, dtype in CASES:
            q = D.preprocess_queries(
                torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev), metric)
            x, norms = D.preprocess_corpus(
                torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev), metric,
                dtype)
            norms[::7] = float("inf")
            ks, ki = FS.launch(fn, q, x, norms, l_bins, metric, precision)
            ps, pi = FS._flat_scan_bins_plain(q, x, norms, l_bins, metric, precision)
            ctx.sync()
            CS.check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi,
                          f"{name} B={b} N={n} D={d} L={l_bins} {metric} {precision}")
        q, x = torch.randn(65, 40, device=dev), torch.randn(256, 40, device=dev)
        x = torch.cat([x, x])
        for precision in ("default", "high"):
            _, ki = FS.launch(fn, q, x, D.sq_norms(x), 256, "l2", precision)
            if not torch.equal(ki, torch.arange(256, device=dev, dtype=torch.int32).expand(65, -1)):
                raise AssertionError(f"{name}: a higher row won a tie ({precision})")
        print(f"  {name}: {len(CASES)} shapes and the tie probe agree with the plain version",
              flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1_000_000, 128, device=dev, generator=g)
    norms = D.sq_norms(x)
    q = x[:2048] + 0.05 * torch.randn(2048, 128, device=dev, generator=g)
    for precision in ("default", "high"):
        for name, fn in fns.items():
            ms = ctx.time_ms(lambda: FS.launch(fn, q, x, norms, 1024, "l2", precision), reps=100,
                             warmup=3)
            ctx.report(f"sweep {precision} {name} ms (B=2048 N=1M D=128 L=1024, 100 calls)", ms)
        ms = ctx.time_ms(lambda: FS.launch(old, q, x, norms, 1024, "l2", precision), reps=20)
        ctx.report(f"sweep {precision} CUDA-core kernel ms (20 calls)", ms)
    qb, xb = q.bfloat16(), x.bfloat16()
    ctx.report("sweep torch.matmul f32 ms", ctx.time_ms(lambda: torch.matmul(q, x.T), reps=5))
    ctx.report("sweep torch.matmul bf16 ms", ctx.time_ms(lambda: torch.matmul(qb, xb.T), reps=10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
