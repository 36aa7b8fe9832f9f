#!/usr/bin/env python3
"""Variants of a hand-written kernel, checked and timed on one card.

    python3 tile_variants.py          # the K2/K3 tensor-core tile
    python3 tile_variants.py cauchy   # K4 cauchy_mean
    python3 tile_variants.py cauchy base no_math   # named variants only
    python3 tile_variants.py nomad    # K1 nomad_step
    python3 tile_variants.py frozen   # K5 frozen_attract
    python3 tile_variants.py sass     # K1's walk: SASS instructions a pair

Each variant is one source edit of a kernel source (the committed source
is ``base``), built with the port's nvcc flags into
``build/tile_variants/<source>/<name>/`` and loaded in place of the
committed kernels. For each variant, in two rounds (forward order, then
reversed, so drift of the card's clock shows as a difference between
rounds), device ms (torch.profiler, ``chip_smoke.device_ms``) and errors.

``tile`` edits ``src/repro_torch/csrc/tf32x3_tile.cuh`` and measures:

* K2 at the fit's 16384×4096×768 and serving's 1024×4096×768, and K3 at
  the candidate 16384×4096×768 and the in-cell 256×305×305×768 shapes;
* ``cell_share``: the largest |kernel − plain| / ``allowed_error`` of the
  in-cell batch (x = y, so the diagonal holds self-distances, d² ≈ 0);
* ``copy_err``: the largest |kernel − plain| of K2's minimum distance on
  rows that are exact copies of a centroid (d² ≈ 0).

``cauchy`` edits ``src/repro_torch/csrc/cauchy_mean.cu`` and the walk it
shares with K1 (``cauchy_walk.cuh``), and measures K4f and K4b at
serving's B 1024 × K 4096 × d 2, with ``share``: the largest
|kernel − plain| / (atol + rtol·|plain|) at chip_smoke's rule for that
shape (atol scaled by the largest output).

``nomad`` edits ``src/repro_torch/csrc/nomad_step.cu`` and
``cauchy_walk.cuh`` (only K1 is rebuilt), and measures K1f (with far, the
fit's forward, and without), K1b and K1f at 4096 heads at the fit's step,
B 8192 × K 4096 × d 2, with the same ``share`` for each output. Its chunk
variants set ``ops.CHUNK`` (the plan is Python's) rather than edit a
source. ``no_fuse_ms``, measured for every variant, times the schedule
of a backward that walks the means again: the forward without far, the
walk with far (the forward with far stands in for it) and the backward's
k + S terms.

``frozen`` edits ``src/repro_torch/csrc/frozen_attract.cu`` and measures
K5f and K5b at serving's B 1024 × k 15 × d 2 (and K5f at 512 queries),
with ``share`` for the loss, gθ and gm at the spec's unscaled
(1e-5, 1e-6). Its lane variants set ``ops.MAX_LANES`` or ``ops.plan``
(the plan is Python's); ``one_thread`` (one lane a query) is the layout
of the kernel before the lanes.

Each edit applies to the first of the family's sources that holds its
old text. Variants that change the arithmetic or drop work (``one_pass``,
``no_split``; ``empty``, ``no_math``, ``no_dsmem``) are timings of what the
dropped part costs, not candidates: their errors are printed, not checked.
Writes ``tile_variants[_<family>].json`` beside ``chip_smoke.json`` and
prints one JSON line per measurement. Runs only on a CUDA card.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
ONE_STEP = """          mma_from_zero(p, as[mt], bb[nt]);
          mma(p, ab[mt], bs[nt]);
          mma(p, ab[mt], bb[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];"""
INT_ROUND = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
# name -> [(old, new)] edits of the tile's source
TILE_VARIANTS = {
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

WALK_LOOP = "      if (head0 >= B) continue;  // uniform over the warp\n"  # cauchy_walk.cuh
FULL_LOOP = "#pragma unroll\n        for (int j = 0; j < TILE / 32; ++j)"
STAGE_LOOP = "      for (int i = threadIdx.x; i < n; i += THREADS) {"
CAUCHY_VARIANTS = {
    "base": [],
    # the correctly rounded IEEE division in place of rcp.approx on the SFU
    "ieee_div": [("const float q = rcp_sfu(s);", "const float q = 1.f / s;")],
    # |θ − μ|² from 0, then 1 + it: one more add a pair
    "add_one_after": [("float diff[D], s = 1.f;", "float diff[D], s = 0.f;"),
                      ("const float q = rcp_sfu(s);", "const float q = rcp_sfu(1.f + s);")],
    # the block's layout: 4 heads a warp and 4 warps (16 heads, 128 threads,
    # 64 pairs a thread) are committed; 2 heads a warp and 8 warps, the loop
    # unrolled by 4, was the first layout (256 threads, 32 pairs a thread)
    "heads2_warps8": [("constexpr int HEADS_PER_WARP = 4;", "constexpr int HEADS_PER_WARP = 2;"),
                      ("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
                      (FULL_LOOP, "#pragma unroll 4\n" + FULL_LOOP.split("\n", 1)[1])],
    "heads2": [("constexpr int HEADS_PER_WARP = 4;", "constexpr int HEADS_PER_WARP = 2;")],  # 1024 blocks
    "warps8": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],  # 256 blocks
    "unroll4": [(FULL_LOOP, "#pragma unroll 4\n" + FULL_LOOP.split("\n", 1)[1])],
    # probes: no reciprocal (q = 1 + |θ − μ|²); each block its own cluster
    # (every result wrong: the cost of scheduling clusters of 8 blocks)
    "no_rcp": [("const float q = rcp_sfu(s);", "const float q = s;")],
    "no_cluster": [("attr[0].val.clusterDim.y = chunks;", "attr[0].val.clusterDim.y = 1;")],
    # rank 0's blocks write the SM clocks they took, start to write, in
    # place of s (k4f_max)
    "clock": [("  if (!W::run(", "  const long long clk0 = clock64();\n  if (!W::run("),
              ("        out[b] = s;", "        out[b] = static_cast<float>(clock64() - clk0);")],
    # a cluster launch that returns at once; staging and the cluster
    # reduction without the pairs; each block keeps its partials
    "empty": [("  if (!W::run(", "  if (B > 0) return;\n  if (!W::run(")],
    "no_math": [(WALK_LOOP, "      continue;\n")],
    "no_dsmem": [("cluster.map_shared_rank(sh.part, 0)", "sh.part")],
}

NOMAD_VARIANTS = {
    "base": [],
    # the correctly rounded IEEE division in place of rcp.approx, in the walk
    # and for the negatives (as in the kernel before the walk was shared)
    "ieee_div": [("const float q = rcp_sfu(s);", "const float q = 1.f / s;"),
                 ("rcp_sfu(s), mn)", "1.f / s, mn)"),
                 ("const float qn = rcp_sfu(s);", "const float qn = 1.f / s;")],
    # heads a lane (and lanes a head over the k + S terms: 32 / heads)
    "heads2": [("constexpr int HEADS_PER_WARP = 4;", "constexpr int HEADS_PER_WARP = 2;")],
    "heads8": [("constexpr int HEADS_PER_WARP = 4;", "constexpr int HEADS_PER_WARP = 8;")],
    "warps8": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],
    "tile512": [("constexpr int TILE = 1024;", "constexpr int TILE = 512;")],  # 1024 means staged a time committed
    # the K split: 4 chunks of 1024 and one of 4096 (ops.CHUNK, below)
    "chunk1024": [],
    "chunk4096": [],
    "unroll4": [(FULL_LOOP, "#pragma unroll 4\n" + FULL_LOOP.split("\n", 1)[1])],
    # probes: no own-cell test (every head keeps its own cell's term: wrong
    # m and far); launches that return at once; the walk without its pairs
    "no_own": [("        if (r0 + r != ob[h]) {", "        {")],
    "empty": [("  if (!W::run(", "  if (B > 0) return;\n  if (!W::run("),
              ("  const float mb = live", "  if (B > 0) return;\n  const float mb = live")],
    "no_math": [(WALK_LOOP, "      continue;\n")],
    # the forward without its negatives and positives (rank 0's tail)
    "no_tail": [("  float mn = 0.f;  // exact in-cell negatives\n  if (live) {",
                 "  float mn = 0.f;  // exact in-cell negatives\n  if (false) {"),
                ("  float l = 0.f;  // attraction + shared log-denominator\n  if (live) {",
                 "  float l = 0.f;  // attraction + shared log-denominator\n  if (false) {")],
    # staging without its global loads (every record (0, .., 0, 1))
    "no_stage_loads": [("        load_mean<D>(mu, t0 + i, vec, v);\n", "        for (int dd = 0; dd < D; ++dd) v[dd] = 0.f;\n"),
                       ("        rec[D] = w[t0 + i];", "        rec[D] = 1.f;")],
    "stage_unroll": [(STAGE_LOOP, "#pragma unroll 4\n" + STAGE_LOOP)],
    # rank 0's tail: its loops unrolled by 2
    "tail_unroll2": [("    for (int j = sub; j < S; j += LANES) {", "#pragma unroll 2\n    for (int j = sub; j < S; j += LANES) {"),
                     ("    for (int j = sub; j < k; j += LANES) {", "#pragma unroll 2\n    for (int j = sub; j < k; j += LANES) {")],
}

ATTRACT_FWD_MATH = "      const float q = inv(1.f + d2);\n      acc = fmaf(w[e], logf(q + mb) + log1pf(d2), acc);\n"
ATTRACT_BWD_MATH = "      const float q = inv(1.f + d2);\n      const float r = inv(q + mb);\n"
FROZEN_VARIANTS = {
    "base": [],
    # lanes a query at k = 15 (ops.MAX_LANES / ops.plan, below): 8 lanes
    # take two neighbours each; 32 leave half the lanes idle; one lane a
    # query walks all 15 in series (the kernel before the lanes)
    "lanes8": [],
    "lanes32": [],
    "one_thread": [],
    # threads a block (256 committed: 64 blocks at B 1024)
    "threads64": [("constexpr int THREADS = 256;", "constexpr int THREADS = 64;")],
    "threads128": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
    "threads512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    # the correctly rounded IEEE division in place of rcp.approx on the SFU
    "ieee_div": [("  asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;",
                  "  return 1.f / x;")],
    # probes: launches that return at once; the loads, butterfly and stores
    # without the reciprocals and logs
    "empty": [("  const Slot sl(lanes);\n  const bool live = sl.b < B;\n  float acc",
               "  if (B > 0) return;\n  const Slot sl(lanes);\n  const bool live = sl.b < B;\n  float acc"),
              ("  const Slot sl(lanes);\n  const bool live = sl.b < B;\n  float g[D]",
               "  if (B > 0) return;\n  const Slot sl(lanes);\n  const bool live = sl.b < B;\n  float g[D]")],
    "no_math": [(ATTRACT_FWD_MATH, "      acc += w[e] + d2 + mb;\n"),
                (ATTRACT_BWD_MATH, "      const float q = d2;\n      const float r = mb;\n")],
}


def build(family, names):
    from repro_torch.kernels import _build

    sources, kernels, variants = family["sources"], family["kernels"], family["variants"]
    procs, libs = {}, {}
    for name in names:
        out_dir = os.path.join(ROOT, "build", "tile_variants", sources[0].split(".")[0], name)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, out_dir)
        texts = {}
        for f in sources:
            with open(os.path.join(out_dir, f)) as fh:
                texts[f] = fh.read()
        missing = False
        for old, new in variants[name]:
            where = next((f for f in sources if old in texts[f]), None)
            if where is None:
                missing = True
                break
            texts[where] = texts[where].replace(old, new)
        if missing:
            print(json.dumps({"variant": name, "skipped": f"an edit no longer matches {', '.join(sources)}"}),
                  flush=True)
            continue
        for f, text in texts.items():
            with open(os.path.join(out_dir, f), "w") as fh:
                fh.write(text)
        for kernel in kernels:
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


def tile_probe(device):
    """Inputs once; returns the measurement of the loaded variant."""
    import torch

    import chip_smoke
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.pairwise import ops as pairwise_ops

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(16384, 768, generator=g, device=device)
    c = torch.randn(4096, 768, generator=g, device=device)
    xs = x[:1024].contiguous()
    cell = torch.randn(256, 305, 768, generator=g, device=device)
    copies = c[torch.arange(0, 4096, 4, device=device)].contiguous()  # each row a centroid
    cell_want = pairwise_ops.pairwise_dist2_plain(cell, cell)
    cell_bound = pairwise_ops.allowed_error(cell, cell)
    copy_want = kmeans_ops.assign_nearest_plain(copies, c)[1]

    def measure():
        cell_got = pairwise_ops.pairwise_dist2_cuda(cell, cell)
        copy_got = kmeans_ops.assign_nearest_cuda(copies, c)[1]
        torch.cuda.synchronize()
        return {
            "k2_ms": chip_smoke.device_ms(lambda: kmeans_ops.assign_nearest_cuda(x, c)),
            "k2_serve_ms": chip_smoke.device_ms(lambda: kmeans_ops.assign_nearest_cuda(xs, c)),
            "k3_cand_ms": chip_smoke.device_ms(lambda: pairwise_ops.pairwise_dist2_cuda(x, c)),
            "k3_cell_ms": chip_smoke.device_ms(lambda: pairwise_ops.pairwise_dist2_cuda(cell, cell)),
            "cell_share": float(((cell_got - cell_want).abs() / cell_bound).max()),
            "copy_err": float((copy_got - copy_want).abs().max()),
        }

    return measure


def cauchy_probe(device):
    import torch

    import chip_smoke
    from repro_torch.kernels.cauchy_mean import ops

    B, K, d = chip_smoke.CAUCHY_SERVE
    g = torch.Generator(device=device).manual_seed(0)
    th = torch.randn(B, d, generator=g, device=device) * 3.0
    mu = torch.randn(K, d, generator=g, device=device) * 3.0
    w = torch.rand(K, generator=g, device=device)
    own = torch.randint(0, K, (B,), generator=g, device=device, dtype=torch.int32)
    gbar = torch.rand(B, generator=g, device=device)
    want_s = ops.cauchy_mean_fwd_plain(th, mu, w, own)
    want_g = ops.cauchy_mean_bwd_plain(th, mu, w, own, gbar)

    def share(got, want):
        rtol, atol = ops.TOL
        return float(((got - want).abs() / (atol * want.abs().max() + rtol * want.abs())).max())

    th2, own2 = th.repeat(2, 1), own.repeat(2)

    def measure():
        s = ops.cauchy_mean_fwd_cuda(th, mu, w, own)
        gt = ops.cauchy_mean_bwd_cuda(th, mu, w, own, gbar)
        torch.cuda.synchronize()
        return {
            "k4f_ms": chip_smoke.device_ms(lambda: ops.cauchy_mean_fwd_cuda(th, mu, w, own)),
            "k4b_ms": chip_smoke.device_ms(lambda: ops.cauchy_mean_bwd_cuda(th, mu, w, own, gbar)),
            # K4f at half and twice the heads: how the time scales with the work
            "k4f_half_ms": chip_smoke.device_ms(lambda: ops.cauchy_mean_fwd_cuda(th[: B // 2], mu, w, own[: B // 2])),
            "k4f_double_ms": chip_smoke.device_ms(lambda: ops.cauchy_mean_fwd_cuda(th2, mu, w, own2)),
            "k4f_max": float(s.max()),
            "k4f_share": share(s, want_s),
            "k4b_share": share(gt, want_g),
        }

    return measure


def nomad_probe(device):
    import torch

    import chip_smoke
    from repro_torch.kernels.nomad_step import ops

    B, k, S, K, d = chip_smoke.NOMAD_MAIN
    args = chip_smoke.nomad_inputs(B, k, S, K, d, device, seed=0)
    gbar = torch.full((B,), 1.0 / B, device=device)
    fwd_p = ops.nomad_step_fwd_plain(*args, want_far=True)
    want = (*fwd_p, *ops.nomad_step_bwd_plain(*args[:5], fwd_p[1], fwd_p[2], gbar))
    h = B // 2
    half = [a[:h].contiguous() if i in (0, 1, 2, 3, 4, 7) else a for i, a in enumerate(args)]

    def share(got, w):
        rtol, atol = ops.TOL
        return float(((got - w).abs() / (atol * w.abs().max() + rtol * w.abs())).max())

    def fused():
        _, m, far = ops.nomad_step_fwd_cuda(*args, want_far=True)
        ops.nomad_step_bwd_cuda(*args[:5], m, far, gbar)

    def unfused():  # the backward walks the means again
        ops.nomad_step_fwd_cuda(*args)
        _, m, far = ops.nomad_step_fwd_cuda(*args, want_far=True)
        ops.nomad_step_bwd_cuda(*args[:5], m, far, gbar)

    def measure():
        fwd = ops.nomad_step_fwd_cuda(*args, want_far=True)
        got = (*fwd, *ops.nomad_step_bwd_cuda(*args[:5], fwd[1], fwd[2], gbar))
        torch.cuda.synchronize()
        _, m, far = fwd
        return {
            "plan": ops.plan(K),
            "k1f_ms": chip_smoke.device_ms(lambda: ops.nomad_step_fwd_cuda(*args, want_far=True)),
            "k1f_nofar_ms": chip_smoke.device_ms(lambda: ops.nomad_step_fwd_cuda(*args)),
            "k1b_ms": chip_smoke.device_ms(lambda: ops.nomad_step_bwd_cuda(*args[:5], m, far, gbar)),
            "pair_ms": chip_smoke.device_ms(fused),
            "no_fuse_ms": chip_smoke.device_ms(unfused),
            "k1f_half_ms": chip_smoke.device_ms(lambda: ops.nomad_step_fwd_cuda(*half, want_far=True)),
            **{f"{label}_share": share(g, w)
               for label, g, w in zip(("loss", "m", "far", "g_i", "g_pos", "g_neg"), got, want)},
        }

    return measure


def frozen_probe(device):
    import torch

    import chip_smoke
    from repro_torch.kernels.frozen_attract import ops

    B, k, d = chip_smoke.ATTRACT_SERVE
    g = torch.Generator(device=device).manual_seed(0)
    th = torch.randn(B, d, generator=g, device=device) * 3.0
    nb = torch.randn(B, k, d, generator=g, device=device) * 3.0
    w = torch.rand(B, k, generator=g, device=device)
    m = torch.rand(B, generator=g, device=device) * 5.0
    gbar = torch.rand(B, generator=g, device=device)
    want = (ops.frozen_attract_fwd_plain(th, nb, w, m), *ops.frozen_attract_bwd_plain(th, nb, w, m, gbar))
    h = B // 2
    half = [t[:h].contiguous() for t in (th, nb, w, m)]

    def share(got, w_):
        rtol, atol = ops.TOL
        return float(((got - w_).abs() / (atol + rtol * w_.abs())).max())

    def measure():
        got = (ops.frozen_attract_fwd_cuda(th, nb, w, m), *ops.frozen_attract_bwd_cuda(th, nb, w, m, gbar))
        torch.cuda.synchronize()
        return {
            "lanes": ops.plan(k),
            "k5f_ms": chip_smoke.device_ms(lambda: ops.frozen_attract_fwd_cuda(th, nb, w, m)),
            "k5b_ms": chip_smoke.device_ms(lambda: ops.frozen_attract_bwd_cuda(th, nb, w, m, gbar)),
            "k5f_half_ms": chip_smoke.device_ms(lambda: ops.frozen_attract_fwd_cuda(*half)),
            **{f"{label}_share": share(a, b) for label, a, b in zip(("loss", "g_theta", "g_m"), got, want)},
        }

    return measure


def sass_mix(entry="nomad_fwd_kernelILi2ELb1E", window=32):
    """Instruction mix of K1's walk as built: ``cuobjdump -sass`` of the
    nomad_step library, in the kernel whose mangled name holds ``entry``
    (d = 2, with far), the instructions from its first LDS.128 to its
    ``window``-th (the fully unrolled tile loop: one 16-byte record load a
    mean for 4 heads), counted by opcode and divided by the MUFU count
    (one reciprocal a pair)."""
    import collections
    import re

    from repro_torch.kernels import _build

    lib = _build.build(("nomad_step",))["nomad_step"]
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s+Function : ", sass) if entry in f.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    loads = [i for i, op in enumerate(ops) if op.startswith("LDS.128")]
    counts = collections.Counter(op.split(".")[0] for op in ops[loads[0]:loads[window - 1]])
    pairs = counts["MUFU"]
    return {"entry": entry, "instructions": sum(counts.values()), "pairs": pairs,
            "per_pair": sum(counts.values()) / pairs, "mix_per_pair": {op: n / pairs for op, n in counts.most_common()}}


FAMILIES = {
    "tile": {"sources": ("tf32x3_tile.cuh",), "kernels": ("kmeans_assign", "pairwise"),
             "variants": TILE_VARIANTS, "probe": tile_probe, "out": "tile_variants.json"},
    "cauchy": {"sources": ("cauchy_mean.cu", "cauchy_walk.cuh"), "kernels": ("cauchy_mean",),
               "variants": CAUCHY_VARIANTS, "probe": cauchy_probe, "out": "tile_variants_cauchy.json"},
    "nomad": {"sources": ("nomad_step.cu", "cauchy_walk.cuh"), "kernels": ("nomad_step",),
              "variants": NOMAD_VARIANTS, "probe": nomad_probe, "out": "tile_variants_nomad.json",
              # module attributes set while a variant is measured
              "settings": ("repro_torch.kernels.nomad_step.ops",
                           {"chunk1024": {"CHUNK": 1024}, "chunk4096": {"CHUNK": 4096}})},
    "frozen": {"sources": ("frozen_attract.cu",), "kernels": ("frozen_attract",),
               "variants": FROZEN_VARIANTS, "probe": frozen_probe, "out": "tile_variants_frozen.json",
               "settings": ("repro_torch.kernels.frozen_attract.ops",
                            {"lanes8": {"MAX_LANES": 8}, "lanes32": {"plan": lambda k: 32},
                             "one_thread": {"MAX_LANES": 1}})},
}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    import chip_smoke

    if argv[:1] == ["sass"]:
        mix = sass_mix()
        print(json.dumps({"card": chip_smoke.card_line(), **mix}), flush=True)
        return 0
    family = FAMILIES[argv[0] if argv else "tile"]
    names = argv[1:] or list(family["variants"])
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(json.dumps({"card": card}), flush=True)
    libs = build(family, names)
    measure = family["probe"](device)
    rounds = []
    order = [n for n in names if n in libs]
    module, settings = family.get("settings", (None, {}))
    for turn in (order, order[::-1]):
        for name in turn:
            use(libs[name])
            saved = {}
            if name in settings:
                mod = importlib.import_module(module)
                for attr, value in settings[name].items():
                    saved[attr] = getattr(mod, attr)
                    setattr(mod, attr, value)
            try:
                row = {"variant": name, **measure()}
            finally:
                for attr, value in saved.items():
                    setattr(mod, attr, value)
            rounds.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, family["out"]), "w") as f:
        json.dump({"card": card, "rounds": rounds}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
