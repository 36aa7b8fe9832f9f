#!/usr/bin/env python3
"""Variants of the K2/K3 tensor-core tile, checked and timed on one card.

    python3 tile_variants.py

Each variant is one source edit of ``src/repro_torch/csrc/tf32x3_tile.cuh``
(the committed tile is ``base``), built with the port's nvcc flags into
``build/tile_variants/<name>/`` and loaded in place of the committed
kernels. For each variant, in two rounds (forward order, then reversed, so
drift of the card's clock shows as a difference between rounds):

* device ms (torch.profiler, ``chip_smoke.device_ms``) of K2 at the fit's
  16384×4096×768 and serving's 1024×4096×768, and of K3 at the candidate
  16384×4096×768 and the in-cell 256×305×305×768 shapes;
* ``cell_share``: the largest |kernel − plain| / ``allowed_error`` of the
  in-cell batch (x = y, so the diagonal holds self-distances, d² ≈ 0);
* ``copy_err``: the largest |kernel − plain| of K2's minimum distance on
  rows that are exact copies of a centroid (d² ≈ 0).

Variants that change the arithmetic (``one_pass``, ``no_split``) are
timings of what the three passes and the split cost, not candidates: their
errors are printed, not checked. Writes ``tile_variants.json`` beside
``chip_smoke.json`` and prints one JSON line per measurement. Runs only on
a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
TILE = "tf32x3_tile.cuh"
ONE_STEP = """          mma_from_zero(p, as[mt], bb[nt]);
          mma(p, ab[mt], bs[nt]);
          mma(p, ab[mt], bb[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];"""
INT_ROUND = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
# name -> [(old, new)] edits of the tile's source
VARIANTS = {
    "base": [],
    # cvt.rna.tf32.f32 in place of the two integer ops
    "cvt": [(INT_ROUND, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));\n  return r;\n')],
    # one accumulator chain: the three mma of every k-step straight into acc
    "one_chain": [(ONE_STEP, """          mma(acc[mt][nt], as[mt], bb[nt]);
          mma(acc[mt][nt], ab[mt], bs[nt]);
          mma(acc[mt][nt], ab[mt], bb[nt]);""")],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "bk16": [("constexpr int BK = 32;", "constexpr int BK = 16;"),
             ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    # arithmetic-changing probes: big.big only (1xTF32), and no split (raw bits)
    "one_pass": [(ONE_STEP, """          mma_from_zero(p, ab[mt], bb[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];""")],
    "no_split": [("  big = to_tf32(v);\n  small = to_tf32(v - __uint_as_float(big));",
                  "  big = small = __float_as_uint(v);")],
}


def build(names):
    from repro_torch.kernels import _build

    procs, libs = {}, {}
    for name in names:
        out_dir = os.path.join(ROOT, "build", "tile_variants", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, out_dir)
        tile = os.path.join(out_dir, TILE)
        with open(tile) as f:
            src = f.read()
        missing = [old for old, _ in VARIANTS[name] if old not in src]
        if missing:
            print(json.dumps({"variant": name, "skipped": "its edit no longer matches the tile"}), flush=True)
            continue
        for old, new in VARIANTS[name]:
            src = src.replace(old, new)
        with open(tile, "w") as f:
            f.write(src)
        for kernel in ("kmeans_assign", "pairwise"):
            lib = os.path.join(out_dir, f"lib{kernel}.so")
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(out_dir, f"{kernel}.cu")]
            procs[(name, kernel)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for (name, kernel), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name} ({kernel}):\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "kernel": kernel, "ptxas": ptxas}), flush=True)
        libs.setdefault(name, {})[kernel] = lib
    return libs


def use(paths):
    """Load one variant's libraries in place of the committed kernels."""
    from repro_torch.kernels import _build

    for kernel, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn, argtypes in _build.SIGNATURES[kernel].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _build._LOADED[kernel] = lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.pairwise import ops as pairwise_ops

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(json.dumps({"card": card}), flush=True)
    libs = build(list(VARIANTS))
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(16384, 768, generator=g, device=device)
    c = torch.randn(4096, 768, generator=g, device=device)
    xs = x[:1024].contiguous()
    cell = torch.randn(256, 305, 768, generator=g, device=device)
    copies = c[torch.arange(0, 4096, 4, device=device)].contiguous()  # each row a centroid
    cell_want = pairwise_ops.pairwise_dist2_plain(cell, cell)
    cell_bound = pairwise_ops.allowed_error(cell, cell)
    copy_want = kmeans_ops.assign_nearest_plain(copies, c)[1]

    rounds = []
    order = [n for n in VARIANTS if n in libs]
    for names in (order, order[::-1]):
        for name in names:
            use(libs[name])
            cell_got = pairwise_ops.pairwise_dist2_cuda(cell, cell)
            copy_got = kmeans_ops.assign_nearest_cuda(copies, c)[1]
            torch.cuda.synchronize()
            row = {
                "variant": name,
                "k2_ms": chip_smoke.device_ms(lambda: kmeans_ops.assign_nearest_cuda(x, c)),
                "k2_serve_ms": chip_smoke.device_ms(lambda: kmeans_ops.assign_nearest_cuda(xs, c)),
                "k3_cand_ms": chip_smoke.device_ms(lambda: pairwise_ops.pairwise_dist2_cuda(x, c)),
                "k3_cell_ms": chip_smoke.device_ms(lambda: pairwise_ops.pairwise_dist2_cuda(cell, cell)),
                "cell_share": float(((cell_got - cell_want).abs() / cell_bound).max()),
                "copy_err": float((copy_got - copy_want).abs().max()),
            }
            rounds.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "tile_variants.json"), "w") as f:
        json.dump({"card": card, "rounds": rounds}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
