#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build every hand-written kernel from ``src/repro_torch/csrc`` with nvcc
   (one process per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   JAX spec's check shapes and at the main path's shapes, and time the
   kernel, the plain version and (where one exists) the one PyTorch call
   that computes the same function; then hold the top-k sites to
   ``jax.lax.top_k``'s order among ties and time both ways of it;
4. the main path: ``NomadProjection(PUBMED.replace(...)).fit(x)`` on cuda
   at PubMed's published widths with N and the epoch count cut (listed in
   ``reduced``), with every kernel's launch count read around it, the
   loss checked to fall, a bit-equality check of two short reruns, and a
   small fit held to the quality bands of the repo's tests;
5. the serving path: ``MapServer.transform`` of 65,536 new queries on the
   frozen N = 1M map (64 batches of 1024 at 24 steps), with its launch
   counts read around it, bit-equal placements at microbatch 512 and
   1024, training rows that find themselves, and one batch profiled;
6. growing the map (``partial_path``): ``partial_fit`` of 32,768 new rows
   of half the mixture's components on the N = 1M map, with every
   kernel's launch count read around it, the grown layout checked
   (capacity, perm, rows) and every untouched cell's rows, kNN and θ held
   bit-identical to the base fit's; then K1, K2 and K4 at the grown K';
7. the map service (``service_path``) on the N = 1M map: the inverse head
   trained on the card; ``MapService.project`` under 1, 8 and 32 client
   threads (launches = device batches × one batch's counts, repeats served
   by the cache), the 8 clients' responses ≡ direct transforms bit for
   bit, ``explore`` ≡ ``FrozenMap.neighbors(decode(·))`` with the card's
   decode held to the CPU's, the busy share of a 32-client run, a hot swap
   to the grown map under 8 clients with every response ≡ a direct
   transform on the version it names, and K2 on each version's centroids;
8. the embed pipeline (``pipeline_path``): Phi-4-mini at its published
   widths (32 layers, d_model 3072, 24 heads of 128 on 8 kv heads, d_ff
   8192, vocabulary 200,064, bf16, attn_chunk 1024; 3.84 B parameters
   initialised on the card from a seeded generator) embeds
   ``class_token_corpus(16,384, 128, 200,064, 8 classes)`` with
   ``embed_to_store`` (doc_batch 128, mean pooling): wall, tokens/s,
   achieved TFLOP/s against the bf16 peak, a batch's busy share, peak
   device memory. On the first 2,048 documents the store's rows ≡
   ``embed_corpus``'s matrix ≡ a second embed, and ``fit`` of the store ≡
   ``fit`` of the matrix, bit for bit. Before that, Phi-4-mini, Mamba-2 and
   Mixtral at their published widths with 2 layers: the card's fp32
   ``hidden_states`` of 4 documents against the port's CPU forward (each
   token's ‖Δ‖/‖h‖ ≤ 1e-4; MoE routes compared, a difference must be a
   near-tie) and the bf16 forward against the fp32 one (median ≤ 0.03,
   max ≤ 0.1); the maxima take each document's tokens before its first
   differing route or capacity keep, and fail if there are none. The corpus
   is mapped (``pipeline_phi4_mini``'s map config at K 64, batch 2,048,
   chunk_rows 4,096), the inverse head trained, saved and scored as
   ``run_pipeline`` strings them, and the map's 10-NN class agreement must
   exceed 0.375 (three times chance; the pooled vectors' printed beside
   it). ``MapRegistry.load(map_dir)`` then serves 1,024 held-out documents
   (``class_token_corpus`` seed 1, embedded by the same model) through
   ``MapService.project`` with one batch's launches (K2 1, K3 4,
   K4f/K4b/K5f/K5b 24 each), ≡ a direct ``MapServer.transform``, and
   ``explore`` of 1,024 map coordinates ≡ ``neighbors(decode(·))``. Every
   kernel is held to its plain version on the phase's own data at its
   shapes: K1 at the fit's step (B 2,048, k 15, S 16, K 64, d 2, drawn from
   the fitted θ), K2 and K3 at D = 3072 (the build, the in-cell kNN, a
   serving batch and its query route), K4 and K5 at the held-out batch (B
   1,024 placements). Last, ``run_pipeline`` for each registered workload
   at its own CPU-sized widths, served from its ``map/``, with the same
   five kernels held to their plain versions on its data. ``reduced``: no
   head or vocabulary padding (a layout, not a cut), random weights, the
   synthetic corpus, and 2 layers and 4 documents in the forward checks.
   Launch counts are read around the map and its serving. The phase's
   files live under ``chiprun_out/pipeline/`` and are deleted at the end;
9. the LM's serving path (``decode_path``): prefill into the KV/SSM cache,
   then ``decode_step``. First, at the published widths with 2 layers in
   fp32 (TF32 off): Phi-4-mini (4 prompts of 1,016 tokens, 8 steps),
   Mamba-2 (4 of 512, 8 steps) and Mixtral (1 of 8,190 tokens, past its
   4,096 window, so the prefill lands in the ring; the 6 steps write slots
   4094, 4095, 0, ..., 3, a further wrap; drop-free capacity 4.0): every
   step's logits within 1e-4 of the full forward's (‖Δ‖/‖logits‖ a
   sequence) and the last step on the card within 1e-4 of the port's CPU
   step from the same cache. Then Phi-4-mini at full depth (the pipeline
   phase's seeded weights, bf16) prefills 16 prompts of 2,048 tokens (two
   attention chunks) and decodes 256 greedy tokens into a cache of 2,304:
   prefill wall, tokens/s and TFLOP/s against the bf16 peak, each step's
   CUDA-event ms (p50, p99), decode tokens/s, one step's busy share, the
   step's bytes bound (weights + the cache read at 3.35 TB/s), peak device
   memory; a rerun gives the same continuations bit for bit; one bf16
   decode step after a 1,023-token prefill against the forward at 1,024
   (median ≤ 0.03, max ≤ 0.1). The continuations are looked up as
   ``examples/serve_lm.py --map-lookup`` does: a 512-document corpus
   embedded by the same model into a store, a small map fitted (K 8, 4
   epochs) and frozen, each prompt's tail + continuation (1,024 tokens)
   embedded and ``FrozenMap.neighbors(·, k=3)`` asked, with one batch's K2
   and K3 launches. Mamba-2 2.7B (64 layers, bf16) serves the same batch
   with the same numbers. The launch counts of the map fit and the lookup
   are the ``decode`` path's;
10. the LM's training path (``train_path``, after the decode phase):
   ``attend_flash``'s output and q/k/v gradients against autograd through
   ``attend_full`` in fp32 (Phi-4-mini's 24 heads on 8 at S 4,096, and
   Mixtral's window of 4,096 at S 8,192; ≤ 1e-5 each) with the backward's
   peak memory of flash below chunked's; the int8 quantiser card ≡ CPU;
   one fp32 train step (accum 1, SGD) of Phi-4-mini, Mamba-2 and Mixtral
   at published widths with 2 layers, card against the port's CPU step
   from one seeded init and one TokenStream batch of 2 × 256 (loss within
   1e-5, each leaf's gradient and SGD-updated weight within 1e-4, MoE
   routes equal or near-ties). Then Phi-4-mini at full depth in bf16 with
   remat "full", flash attention and AdamW's int8 moments trains on
   TokenStream batches of 8 × 4,096 (4 pre-split microbatches of 2): 2
   warm-up and 6 timed steps (CUDA events), the loss must fall; step p50
   and p99, tokens/s, model and hardware TFLOP/s, peak memory, the moments'
   bytes, and one microbatch's forward and backward profiled, without an
   update (busy share, ten largest kernels). The
   trained model embeds class_token_corpus(2,048, 128) into a store that
   ``pipeline_phi4_mini``'s map config fits (K1-K3 launches, the ``train``
   path's), and every kernel of the map is held against its plain version
   on those rows (as the pipeline phase does); two 2-step runs at 2 layers are compared bit for bit
   (reported, not gated); Mamba-2 at its published widths with 16 of its
   64 layers takes 3 steps the same way (finite losses);
11. the launcher (``launch_path``): ``python -m repro_torch.launch.train
   --workload nomad_pubmed --n-points 262144 --epochs 4 --checkpoint-every
   1`` (PubMed's widths: dim 768, K 4096, k 15, S 128, batch 8192; N and
   the epochs cut, ``LAUNCH_REDUCED``) run in process through
   ``launch.train.main`` with K1-K3's launches read around it (the
   ``launch`` path's counts); a child crashed with ``--fail-at-epoch 3``
   (exit 17) and a child resumed with ``--resume --out … --metrics``
   (``index: cache``, ``resume: epoch 2`` or ``3``) whose embedding equals
   the uninterrupted run's bit for bit; then on the same data
   ``build_index(x, cfg)`` ≡ ``IndexBuilder(cfg).build(x)`` bit for bit and
   ``kmeans_fit`` (K2 launched, its assignment the plain nearest centroid
   of its centroids on ≥ 0.99 of the rows, counts its bincount);
12. the multi-GPU NOMAD side (``sharded_path``) on 4 shard slots of the
   card: the sharded build, fits and serving ≡ local where the reference
   promises it, and the NCCL launcher at world size 1;
13. the LM side (``lm_sharded_path``): Mixtral's ``moe_ep`` through
   ``lm.forward`` (true EP on (1, 4) ≡ ``moe_sort`` bit for bit in fp32 and
   bf16, the F split on (1, 16) within ``FWD_FP32_REL``), Scout's MoE
   block with its shared expert ≡ sort, the length-sharded decode of
   Phi-4-mini (fp32 and bf16) and of Mixtral across its ring, Qwen3-14B's
   GPipe ≡ sequential bit for bit, ``compressed_psum`` card ≡ CPU bit for
   bit with its feedback telescoping, and the port's two selftests (their
   K1-K3 launches the kernels line's ``selftest`` column; every kernel of
   the NOMAD selftest then against its plain version on that selftest's
   own inputs, ``selftest_kernels``);
14. the kernels' specs and the autotuner (``autotune_check``): every K2/K3
   plan ≡ the default bit for bit at each check shape, sweeps at the main
   path's shapes, ``validate`` of every spec, the cache's round trip (K3's
   wrapper, called without a plan, running the cached tile), no launch
   counted;
15. the dry run (``dryrun_check``): ``launch.dryrun.run_lm_cell`` on meta
   tensors of the train phase's Phi-4-mini cell (8 × 4,096 tokens, accum 4,
   remat full, flash, int8 moments) and the decode phase's Phi-4-mini
   step: the predicted ``per_device_total`` beside the measured peaks
   (reported), and the op counter's matrix-product FLOPs beside
   ``train_flops``' hardware count, within 5% (the gate);
16. a checkpoint round trip at the small fit's size: fit with
   ``checkpoint_dir`` (saved by the asynchronous writer),
   ``NomadProjection.from_checkpoint(dir).transform``
   bit-equal to the fitted estimator's, and the same frozen map served on
   the CPU (plain versions) close to the card's; an inverse head saved
   beside it, picked up by ``registry.swap(dir)`` and served; the same fit
   saved by a synchronous writer leaves the same checkpoints (arrays and
   manifests), and a fit stopped right after a save returns has committed
   it and resumes bit-equal to the uninterrupted fit; then
   ``partial_fit`` at that size (``partial_small``): place-only ≡
   transform, determinism, the lineage v0 → v1 → v2 (served by
   ``registry.load_lineage``), store ≡ array growth, the kNN patch in
   blocks ≡ one batch, and the old rows' quality against a joint refit;
17. the stream path: the main path's rows written as a bfloat16 sharded
   store under ``chiprun_out/`` and fitted from disk in 65,536-row chunks
   in a child process (its own peak RSS, stage times, launch counts), its
   map serving 4,096 queries from an ``.npy`` memmap and path bit-equal to
   the array's; the same rows fitted resident in a second child for its
   RSS, and here with the same chunks: bit-equal to the store's fit; then
   the randomized PCA (D 4096) on the card against the CPU. The store and
   its spill are deleted at the end;
18. the kernel table (the contract line), then the card, then the result.

It exits non-zero, printing no result, when no CUDA device is present or
when the repository's ``src/`` is not beside it. Details of every check
are written to ``chiprun_out/chip_smoke.json``. ``--child MODE WORK DEVICE
CONFIG`` is the stream phase's own entry for its child processes.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# set before torch starts CUDA: the train phase's Phi-4-mini step peaks at
# ~65 GB of an NVIDIA H100 80GB HBM3's 80 (700 W) with (2, 4096, 200,064)
# float32 logits and their gradient coming and going, and the fixed-size
# segments left ~15 GB of it reserved but unusable (an out-of-memory stop)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# the H100's peaks, one table for the port (repro_torch.roofline.analysis,
# from the NVIDIA H100 SXM data sheet): fp32 on CUDA cores (no tensor
# cores), TF32 and bf16 on the tensor cores (dense), the HBM3 rate. In a
# directory without the repository's src/ this import fails first.
from repro_torch.roofline.analysis import HW_H100  # noqa: E402

PEAK_FP32_FLOPS = HW_H100["peak_flops_fp32"]
PEAK_TF32_FLOPS = HW_H100["peak_flops_tf32"]
PEAK_BF16_FLOPS = HW_H100["peak_flops"]
TF32X3_PASSES = 3  # the 3xTF32 tile of K2 and K3 runs three TF32 products
PEAK_BYTES_PER_S = HW_H100["hbm_bw"]

# the main path: PubMed's published widths, N and epochs cut to fit one call
MAIN_N = 1_000_000
MAIN_EPOCHS = 4
MAIN_COMPONENTS = 4096
FIT_KERNELS = ("nomad_step_fwd", "nomad_step_bwd", "kmeans_assign", "pairwise")
SERVE_KERNELS = ("kmeans_assign", "pairwise", "cauchy_mean_fwd", "cauchy_mean_bwd",
                 "frozen_attract_fwd", "frozen_attract_bwd")
SERVE_Q = 65_536  # 64 batches of serve_microbatch 1024
INVARIANCE_Q = 4096  # placed at microbatch 512 and 1024
REDUCED = [
    "n_points 24,000,000 -> 1,000,000 (one card, one call's time limit)",
    f"n_epochs 60 -> {MAIN_EPOCHS}",
    "data: seeded Gaussian mixture (4096 components at dim 768) in place of PubMed BERT vectors",
]


def main_config():
    """PUBMED at its published widths (serving: microbatch 1024, 24 steps),
    N and epochs cut as REDUCED says."""
    from repro_torch.configs import PUBMED

    return PUBMED.replace(n_points=MAIN_N, n_epochs=MAIN_EPOCHS)


SFU_PER_CLOCK = 16  # reciprocals (and logs) an SM issues a clock on its special-function units


@functools.lru_cache(maxsize=None)
def sfu_rate() -> float:
    """SFU operations a second of the whole card: SMs × 16 a clock × the
    card's top SM clock (nvidia-smi's clocks.max.sm), read from the card
    (``HW_H100["sfu_rate"]`` is the same product at the H100 SXM's 132 SMs
    and 1.98 GHz)."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * SFU_PER_CLOCK * float(mhz) * 1e6


def bound_ms(flops: float, nbytes: float, tensor_cores: bool = False, sfu: float = 0.0):
    """The least time for the work: the largest of its operations at the
    card's peak and its bytes at the memory rate. ``tensor_cores``: the
    operations are the 3xTF32 tile's, three TF32 passes at the tensor-core
    rate; otherwise fp32 on CUDA cores. ``sfu``: reciprocals and logs on
    the special-function units (:func:`sfu_rate`), which run beside the
    CUDA cores, so they bound the operations' time where they take longer."""
    if tensor_cores:
        t_ops = TF32X3_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    else:
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
    if sfu:
        t_ops = max(t_ops, sfu / sfu_rate() * 1e3)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: its kernels' time under
    torch.profiler over ``reps`` calls. Unlike :func:`time_ms` it leaves
    out the host's cost of a launch, which holds a kernel of a few
    microseconds to the rate the host can enqueue it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kernels) / 1e3 / reps


def _gen(device, seed):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def nomad_inputs(B, k, S, K, d, device, seed=0):
    """The JAX spec's input distribution (``nomad_step/ops.py:_make_inputs``)."""
    import torch

    g = _gen(device, seed)
    n = lambda *s: torch.randn(s, generator=g, device=device) * 3.0  # noqa: E731
    u = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    own = torch.randint(0, K, (B,), generator=g, device=device, dtype=torch.int32)
    return n(B, d), n(B, k, d), u(B, k), n(B, S, d), u(B, S), n(K, d), u(K), own


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _close(got, want, rtol, atol) -> bool:
    import torch

    return bool(torch.all((got - want).abs() <= atol + rtol * want.abs()))


def _check_pair(name, outs, tol, scaled):
    """Every (kernel, plain) output pair within (rtol, atol); with
    ``scaled`` atol is tol[1] times the output's largest magnitude (a sum
    over K = 4096 terms rounds with the summed magnitudes, not the result)."""
    import torch

    errs, ok = {}, True
    for label, (g, w) in outs.items():
        atol = tol[1] * float(w.abs().max()) if scaled else tol[1]
        errs[label] = _max_err(g, w)
        ok &= bool(torch.isfinite(g).all()) and _close(g, w, tol[0], atol)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {errs}")
    return errs


def nomad_pair(args, gbar) -> dict:
    """K1's forward (with far) and backward on the card and in the plain
    versions, {output: (kernel, plain)}; the forward without far must give
    the same loss and m bits as the forward with it."""
    import torch

    from repro_torch.kernels.nomad_step import ops

    fwd = ops.nomad_step_fwd_cuda(*args, want_far=True)
    fwd_p = ops.nomad_step_fwd_plain(*args, want_far=True)
    loss_n, m_n, _ = ops.nomad_step_fwd_cuda(*args)
    if not (torch.equal(loss_n, fwd[0]) and torch.equal(m_n, fwd[1])):
        raise AssertionError("nomad_step_fwd without far differs from the forward with far")
    grads = ops.nomad_step_bwd_cuda(*args[:5], fwd[1], fwd[2], gbar)
    grads_p = ops.nomad_step_bwd_plain(*args[:5], fwd_p[1], fwd_p[2], gbar)
    torch.cuda.synchronize()
    return dict(zip(("loss", "m", "far", "g_i", "g_pos", "g_neg"), zip((*fwd, *grads), (*fwd_p, *grads_p))))


def check_nomad_step(device, shapes, main_shape):
    """K1 forward and backward against the plain versions.

    Check shapes: the spec's (rtol, atol) = (2e-5, 2e-5), gbar = 1/B (the
    batch mean's cotangent, as on the main path). At K ≥ 4096 (the main
    shape, and the 3-chunk plan of a map grown past 4096 cells): every
    output is a sum over K signed terms whose rounding error scales with
    the summed magnitudes, not the (cancelled) result, so atol is 2e-5 of
    the output's largest magnitude there. At every shape the forward
    without far (no gradient wanted) gives the same loss and m bits as the
    forward with it. At the main shape also: rows [0, B/2) of the call
    bit-equal to a B/2-head call (the K split follows K alone).
    """
    import torch

    from repro_torch.kernels.nomad_step import ops

    rows = []
    for shape in list(shapes) + [main_shape]:
        B, k, S, K, d = shape
        args = nomad_inputs(B, k, S, K, d, device, seed=sum(shape))
        gbar = torch.full((B,), 1.0 / B, device=device)
        errs = _check_pair(f"nomad_step at {shape}", nomad_pair(args, gbar), ops.TOL, K >= 4096)
        rows.append({"shape": shape, "plan": ops.plan(K), "max_abs_err": errs, "ok": True})

    B, k, S, K, d = main_shape
    args = nomad_inputs(B, k, S, K, d, device, seed=1)
    gbar = torch.full((B,), 1.0 / B, device=device)
    loss, m, far = ops.nomad_step_fwd_cuda(*args, want_far=True)
    grads = ops.nomad_step_bwd_cuda(*args[:5], m, far, gbar)
    h = B // 2
    half = [a[:h].contiguous() if i in (0, 1, 2, 3, 4, 7) else a for i, a in enumerate(args)]
    half_f = ops.nomad_step_fwd_cuda(*half, want_far=True)
    half_b = ops.nomad_step_bwd_cuda(*half[:5], half_f[1], half_f[2], gbar[:h].contiguous())
    if not all(torch.equal(a[:h], b) for a, b in zip((loss, m, far, *grads), (*half_f, *half_b))):
        raise AssertionError(f"nomad_step: rows of a {h}-head call differ from the same rows of a {B}-head call")
    rows.append({"batch_invariance": (h, B), "bit_equal": True, "ok": True})

    chunks, chunk_len = ops.plan(K)
    launch = {"chunks": chunks, "chunk_len": chunk_len, "cluster": (1, chunks, 1),
              "blocks": chunks * -(-B // ops.HEADS), "threads": ops.THREADS, "heads_per_block": ops.HEADS,
              "bwd_blocks": -(-B // ops.HEADS), "lanes_per_head": ops.LANES}
    # a fused pair of the forward: d subtractions, d fmaf (1 + |θ − μ|² from
    # 1), an fmaf for m, two products for cw·q², d fmaf for far
    fwd_flops = B * (K * (5 * d + 4) + (k + S) * (3 * d + 12))
    bwd_flops = B * (k + S) * (8 * d + 8)
    per_head_in = B * d + B * k * d + B * k + B * S * d + B * S  # θ, θpos, pw, θneg, nw
    fwd_bytes = 4.0 * (per_head_in + K * d + K + B + B * (2 + d))  # + μ, cw, own; loss, m, far out
    bwd_bytes = 4.0 * (per_head_in + B * (2 + d) + B * d + B * k * d + B * S * d)  # + m, far, ḡ; grads out
    # SFU work as csrc/nomad_step.cu takes it: the forward a reciprocal for
    # every head-mean pair (the own cell's too) and each negative, and per
    # positive a division, logf and log1pf; the backward a reciprocal per
    # negative and three divisions per positive
    sfu_fwd, sfu_bwd = B * K + B * S + 3 * B * k, B * S + 3 * B * k
    errs = [r["max_abs_err"] for r in rows if "shape" in r]

    def timed(fn, plain, flops, nbytes, sfu, err):
        return {"shape": main_shape, "plan": launch, "ms": time_ms(fn, reps=50), "device_ms": device_ms(fn),
                "plain_ms": time_ms(plain), "bound": bound_ms(flops, nbytes, sfu=sfu),
                "bound_no_sfu": bound_ms(flops, nbytes), "sfu_ops": sfu, "library_ms": None, "max_abs_err": err}

    timing = {
        "nomad_step_fwd": timed(lambda: ops.nomad_step_fwd_cuda(*args, want_far=True),
                                lambda: ops.nomad_step_fwd_plain(*args, want_far=True), fwd_flops, fwd_bytes,
                                sfu_fwd, max(max(e["loss"], e["m"], e["far"]) for e in errs)),
        "nomad_step_bwd": timed(lambda: ops.nomad_step_bwd_cuda(*args[:5], m, far, gbar),
                                lambda: ops.nomad_step_bwd_plain(*args[:5], m, far, gbar), bwd_flops, bwd_bytes,
                                sfu_bwd, max(max(e["g_i"], e["g_pos"], e["g_neg"]) for e in errs)),
    }
    # the forward without far, as a no-grad caller runs it
    timing["nomad_step_fwd"]["device_ms_without_far"] = device_ms(lambda: ops.nomad_step_fwd_cuda(*args))
    return rows, timing


def check_kmeans_assign(device, shapes, main_shape, serve_shape):
    """K2 against its plain version by the JAX spec's oracle rule: minimum
    distances within (1e-4, 1e-4), chosen centroids distance-equivalent, at
    the spec's shapes, the fit's block and serving's batch; then the tie
    case at both main-path row counts; then both timed."""
    import torch

    from repro_torch.kernels.kmeans_assign import ops

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for i, (n, k, d) in enumerate(list(shapes) + [main_shape, serve_shape]):
        g = _gen(device, 100 + i)
        x = torch.randn(n, d, generator=g, device=device)
        c = torch.randn(k, d, generator=g, device=device)
        got = ops.assign_nearest_cuda(x, c)
        want = ops.assign_nearest_plain(x, c)
        torch.cuda.synchronize()
        ops.oracle_check(x, c, got, want)  # raises on disagreement
        rows.append({
            "shape": (n, k, d),
            "chunks": ops.plan(n, k, sms)[0],
            "max_abs_err": _max_err(got[1], want[1]),
            "argmin_equal_frac": float((got[0] == want[0]).float().mean()),
            "ok": True,
        })
    ties = [kmeans_ties(device, n, *main_shape[1:], sms) for n in (serve_shape[0], main_shape[0])]

    def timed(n, k, d, seed):
        g = _gen(device, seed)
        x = torch.randn(n, d, generator=g, device=device)
        c = torch.randn(k, d, generator=g, device=device)

        def library():  # two calls: the distance matrix, then its row minimum
            return torch.cdist(x, c, compute_mode="use_mm_for_euclid_dist").min(-1)

        flops, nbytes = 2.0 * n * k * d + 2.0 * n * k, 4.0 * (n * d + k * d + 2 * n)
        chunks, chunk_cols = ops.plan(n, k, sms)
        return {
            "shape": (n, k, d),
            "route": "tile", "tile": (ops.TILE, ops.TILE), "chunks": chunks, "chunk_cols": chunk_cols,
            "ms": time_ms(lambda: ops.assign_nearest_cuda(x, c)),
            "device_ms": device_ms(lambda: ops.assign_nearest_cuda(x, c)),
            "plain_ms": time_ms(lambda: ops.assign_nearest_plain(x, c)),
            "library_ms": time_ms(library),
            "library_call": "torch.cdist(x, c, compute_mode='use_mm_for_euclid_dist').min(-1) (two calls)",
            "bound": bound_ms(flops, nbytes, tensor_cores=True),
            "bound_fp32": bound_ms(flops, nbytes),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
        }

    timing = {"kmeans_assign": timed(*main_shape, seed=7),
              "kmeans_assign[serve batch]": timed(*serve_shape, seed=8)}
    return rows + ties, timing


def kmeans_ties(device, n, k, d, sms):
    """Duplicated centroids across chunk boundaries (c[2053] = c[5],
    c[K-1] = c[0]) and every row drawn at or next to c[5] or c[0]: the
    distances to a centroid and its copy are the same bits, so the argmin
    must be the lower index on every row, as torch.argmin gives it. Rows
    next to the copies (noise 0.5 a coordinate, still far nearer to them
    than to any other centroid) are held to the oracle rule. Rows that
    are exact copies have d² ≈ 0 against ‖x‖² + ‖c‖² ≈ 1536: there the
    rule's 1e-4 is below fp32's own rounding (the plain version misses the
    true 0 by up to ~2e-3), so their minimum is held to K3's scaled bound,
    ``pairwise/ops.py:allowed_error``."""
    import torch

    from repro_torch.kernels.kmeans_assign import ops
    from repro_torch.kernels.pairwise.ops import allowed_error

    g = _gen(device, 300 + n)
    c = torch.randn(k, d, generator=g, device=device)
    c[2053] = c[5]
    c[k - 1] = c[0]
    lower = torch.tensor([5, 0], device=device).repeat(n // 2)
    near = torch.arange(n, device=device) % 4 >= 2  # the others are exact copies
    x = c[lower] + 0.5 * near.float()[:, None] * torch.randn(n, d, generator=g, device=device)
    got = ops.assign_nearest_cuda(x, c)
    want = ops.assign_nearest_plain(x, c)
    torch.cuda.synchronize()
    if not torch.equal(got[0].long(), lower):
        bad = int((got[0].long() != lower).sum())
        raise AssertionError(f"kmeans_assign ties at {n} rows: {bad} rows did not keep the lower index")
    ops.oracle_check(x[near], c, (got[0][near], got[1][near]), (want[0][near], want[1][near]))
    copy = ~near
    err = (got[1][copy] - want[1][copy]).abs()
    bound = allowed_error(x[copy][:, None, :], c[lower[copy]][:, None, :])[:, 0, 0]
    if not bool(torch.all(err <= bound)):
        raise AssertionError(f"kmeans_assign ties at {n} rows: exact copies off by {float(err.max())}")
    return {"tie_case": (n, k, d), "chunks": ops.plan(n, k, sms)[0], "lower_index_rows": n,
            "near_rows_max_abs_err": _max_err(got[1][near], want[1][near]),
            "copy_rows_max_abs_err": float(err.max()), "copy_rows_bound_min": float(bound.min()),
            "plain_argmin_equal_frac": float((want[0].long() == lower).float().mean()), "ok": True}


def check_pairwise(device, shapes, cand_shape, cell_shape, query_shape):
    """K3 against its plain version: the spec's (2e-5, 2e-5) at its check
    shapes; at D = 768 the error bound scaled by ‖x‖² + ‖y‖²
    (``pairwise/ops.py:allowed_error``). The batched shapes are the in-cell
    kNN's (each cell against itself) and serving's query kNN (each query,
    one row, against its own cell: x and y drawn apart, n ≠ m)."""
    import torch

    from repro_torch.kernels.pairwise import ops

    rows = []
    cases = [(None, s, False) for s in shapes] + [
        (None, cand_shape, False), (cell_shape[0], cell_shape[1:], True), (query_shape[0], query_shape[1:], False)]
    for i, (batch, (n, m, d), same) in enumerate(cases):
        g = _gen(device, 200 + i)
        if same:  # in-cell: each cell against itself
            x = y = torch.randn(batch, n, d, generator=g, device=device)
        else:
            lead = () if batch is None else (batch,)
            x = torch.randn(*lead, n, d, generator=g, device=device)
            y = torch.randn(*lead, m, d, generator=g, device=device)
        got = ops.pairwise_dist2_cuda(x, y)
        want = ops.pairwise_dist2_plain(x, y)
        torch.cuda.synchronize()
        if d <= 128:
            ok = _close(got, want, *ops.SPEC_TOL)
        else:
            ok = bool(torch.all((got - want).abs() <= ops.allowed_error(x, y)))
        rows.append({"batch": batch, "shape": (n, m, d), "max_abs_err": _max_err(got, want), "ok": ok})
        if not ok:
            raise AssertionError(f"pairwise disagrees with its plain version: {rows[-1]}")

    def timed(x, y, batch):
        n, m, d = x.shape[-2], y.shape[-2], x.shape[-1]
        b = batch or 1
        way = ops.route(b, n, m, d)
        tile = ops.tile_for(n, m) if way == "tile" else None
        flops, nbytes = b * (2.0 * n * m * d + 4.0 * n * m), 4.0 * b * (n * d + m * d + n * m)
        return {
            "shape": (batch, n, m, d),
            "route": way, "tile": (tile, tile) if tile else None,
            "ms": time_ms(lambda: ops.pairwise_dist2_cuda(x, y)),
            "device_ms": device_ms(lambda: ops.pairwise_dist2_cuda(x, y)),
            "plain_ms": time_ms(lambda: ops.pairwise_dist2_plain(x, y)),
            "library_ms": time_ms(lambda: torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist")),
            "library_call": "torch.cdist(x, y, compute_mode='use_mm_for_euclid_dist') (distances, not squared)",
            "bound": bound_ms(flops, nbytes, tensor_cores=way == "tile"),
            "bound_fp32": bound_ms(flops, nbytes),
        }

    g = _gen(device, 9)
    n, m, d = cand_shape
    x = torch.randn(n, d, generator=g, device=device)
    y = torch.randn(m, d, generator=g, device=device)
    cand = timed(x, y, None)
    cand["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    b, n, _, d = cell_shape
    xc = torch.randn(b, n, d, generator=g, device=device)
    cell = timed(xc, xc, b)
    b, n, m, d = query_shape
    query = timed(torch.randn(b, n, d, generator=g, device=device),
                  torch.randn(b, m, d, generator=g, device=device), b)
    return rows, {"pairwise": cand, "pairwise[in-cell batch]": cell, "pairwise[query batch]": query}


def check_cauchy_mean(device, shapes, main_shape):
    """K4 forward and backward against the plain versions at the JAX spec's
    check shapes, (rtol, atol) = (1e-5, 1e-6), and at K ≥ 4096 (the
    serving shape, B 1024 against K 4096 means, and a grown map's K 4133,
    whose chunks of 544 stage a full tile and a tail) with atol scaled by
    the largest output.
    At the serving shape also: rows [0, B/2) of the call bit-equal to a
    B/2-head call (the K split follows K alone), and heads whose own cell
    is a chunk's first or last mean (each head 0.1 from it, so a term
    wrongly kept or dropped would show) against the plain versions."""
    import torch

    from repro_torch.kernels.cauchy_mean import ops

    def inputs(B, K, d, seed):  # the JAX spec's distribution (ops.py:_make_inputs)
        g = _gen(device, seed)
        return (torch.randn(B, d, generator=g, device=device) * 3.0,
                torch.randn(K, d, generator=g, device=device) * 3.0,
                torch.rand(K, generator=g, device=device),
                torch.randint(0, K, (B,), generator=g, device=device, dtype=torch.int32),
                torch.rand(B, generator=g, device=device))

    def pair(th, mu, w, own, gbar):
        return {"s": (ops.cauchy_mean_fwd_cuda(th, mu, w, own), ops.cauchy_mean_fwd_plain(th, mu, w, own)),
                "g_theta": (ops.cauchy_mean_bwd_cuda(th, mu, w, own, gbar),
                            ops.cauchy_mean_bwd_plain(th, mu, w, own, gbar))}

    rows = []
    for shape in list(shapes) + [main_shape]:
        outs = pair(*inputs(*shape, seed=sum(shape)))
        torch.cuda.synchronize()
        rows.append({"shape": shape, "plan": ops.plan(shape[1]),
                     "max_abs_err": _check_pair("cauchy_mean", outs, ops.TOL, shape[1] >= 4096), "ok": True})

    B, K, d = main_shape
    chunks, chunk_len = ops.plan(K)
    th, mu, w, own, gbar = inputs(B, K, d, seed=5)
    h = B // 2
    half = (th[:h].contiguous(), mu, w, own[:h].contiguous())
    if not (torch.equal(ops.cauchy_mean_fwd_cuda(th, mu, w, own)[:h], ops.cauchy_mean_fwd_cuda(*half))
            and torch.equal(ops.cauchy_mean_bwd_cuda(th, mu, w, own, gbar)[:h],
                            ops.cauchy_mean_bwd_cuda(*half, gbar[:h].contiguous()))):
        raise AssertionError(f"cauchy_mean: rows of a {h}-head call differ from the same rows of a {B}-head call")
    edges = torch.tensor([0, chunk_len - 1, chunk_len, K - 1], device=device, dtype=torch.int32)
    own_e = edges.repeat(B // 4)
    th_e = mu[own_e.long()] + 0.1 * torch.randn(B, d, generator=_gen(device, 6), device=device)
    edge_errs = _check_pair("cauchy_mean (own at chunk boundaries)", pair(th_e, mu, w, own_e, gbar), ops.TOL, True)
    rows.append({"batch_invariance": (h, B), "bit_equal": True, "ok": True})
    rows.append({"own_at_chunk_boundaries": edges.tolist(), "max_abs_err": edge_errs, "ok": True})

    *args, gbar = inputs(B, K, d, seed=3)
    in_bytes = 4.0 * (B * d + K * d + K + B)
    launch = {"chunks": chunks, "chunk_len": chunk_len, "cluster": (1, chunks, 1),
              "blocks": chunks * -(-B // ops.HEADS), "threads": ops.THREADS, "heads_per_block": ops.HEADS}
    sfu = B * K  # one reciprocal a pair

    def timed(fn, plain, flops, nbytes, err):
        return {"shape": main_shape, "plan": launch,
                "ms": time_ms(fn, reps=50), "device_ms": device_ms(fn), "plain_ms": time_ms(plain),
                "bound": bound_ms(flops, nbytes, sfu=sfu), "bound_no_sfu": bound_ms(flops, nbytes),
                "sfu_ops": sfu, "library_ms": None, "max_abs_err": err}

    errs = [r["max_abs_err"] for r in rows if "shape" in r] + [edge_errs]
    timing = {
        "cauchy_mean_fwd": timed(lambda: ops.cauchy_mean_fwd_cuda(*args), lambda: ops.cauchy_mean_fwd_plain(*args),
                                 B * K * (3.0 * d + 4), in_bytes + 4.0 * B, max(e["s"] for e in errs)),
        "cauchy_mean_bwd": timed(lambda: ops.cauchy_mean_bwd_cuda(*args, gbar),
                                 lambda: ops.cauchy_mean_bwd_plain(*args, gbar),
                                 B * K * (5.0 * d + 4), in_bytes + 4.0 * B * (1 + d), max(e["g_theta"] for e in errs)),
    }
    return rows, timing


def check_frozen_attract(device, shapes, main_shape):
    """K5 forward and backward against the plain versions at the JAX spec's
    check shapes, k = 40 (more neighbours than a warp has lanes) and the
    serving shape (B 1024, k 15), (1e-5, 1e-6): each output sums only k
    terms. At the serving shape also: rows [0, B/2) of the call bit-equal
    to a B/2-query call (the lanes a query follow k alone)."""
    import torch

    from repro_torch.kernels.frozen_attract import ops

    def inputs(B, k, d, seed):  # the JAX spec's distribution (ops.py:_make_inputs)
        g = _gen(device, seed)
        return (torch.randn(B, d, generator=g, device=device) * 3.0,
                torch.randn(B, k, d, generator=g, device=device) * 3.0,
                torch.rand(B, k, generator=g, device=device),
                torch.rand(B, generator=g, device=device) * 5.0,
                torch.rand(B, generator=g, device=device))

    def launch(B, k):
        lanes = ops.plan(k)
        return {"lanes": lanes, "threads": ops.THREADS, "blocks": -(-B * lanes // ops.THREADS)}

    rows = []
    for shape in list(shapes) + [main_shape]:
        *args, gbar = inputs(*shape, seed=sum(shape))
        (gt, gm), (gt_p, gm_p) = ops.frozen_attract_bwd_cuda(*args, gbar), ops.frozen_attract_bwd_plain(*args, gbar)
        outs = {"loss": (ops.frozen_attract_fwd_cuda(*args), ops.frozen_attract_fwd_plain(*args)),
                "g_theta": (gt, gt_p), "g_m": (gm, gm_p)}
        torch.cuda.synchronize()
        rows.append({"shape": shape, "plan": launch(shape[0], shape[1]),
                     "max_abs_err": _check_pair("frozen_attract", outs, ops.TOL, False), "ok": True})
    B, k, d = main_shape
    th, nb, w, m, gbar = inputs(B, k, d, seed=5)
    h = B // 2
    half = [t[:h].contiguous() for t in (th, nb, w, m)]
    full = (ops.frozen_attract_fwd_cuda(th, nb, w, m), *ops.frozen_attract_bwd_cuda(th, nb, w, m, gbar))
    part = (ops.frozen_attract_fwd_cuda(*half), *ops.frozen_attract_bwd_cuda(*half, gbar[:h].contiguous()))
    if not all(torch.equal(a[:h], b) for a, b in zip(full, part)):
        raise AssertionError(f"frozen_attract: rows of a {h}-query call differ from the same rows of a {B}-query call")
    rows.append({"batch_invariance": (h, B), "bit_equal": True, "ok": True})

    *args, gbar = inputs(B, k, d, seed=4)
    in_bytes = 4.0 * (B * d + B * k * d + B * k + B)
    # SFU work as csrc/frozen_attract.cu takes it, per neighbour: a
    # reciprocal, logf and log1pf (forward) or two reciprocals (backward)
    sfu_fwd, sfu_bwd = 3 * B * k, 2 * B * k
    errs = [r["max_abs_err"] for r in rows if "shape" in r]

    def timed(fn, plain, flops, nbytes, sfu, err):
        return {"shape": main_shape, "plan": launch(B, k),
                "ms": time_ms(fn, reps=50), "device_ms": device_ms(fn), "plain_ms": time_ms(plain),
                "bound": bound_ms(flops, nbytes, sfu=sfu), "bound_no_sfu": bound_ms(flops, nbytes),
                "sfu_ops": sfu, "library_ms": None, "max_abs_err": err}

    timing = {
        "frozen_attract_fwd": timed(lambda: ops.frozen_attract_fwd_cuda(*args),
                                    lambda: ops.frozen_attract_fwd_plain(*args),
                                    B * k * (3.0 * d + 12), in_bytes + 4.0 * B, sfu_fwd, max(e["loss"] for e in errs)),
        "frozen_attract_bwd": timed(lambda: ops.frozen_attract_bwd_cuda(*args, gbar),
                                    lambda: ops.frozen_attract_bwd_plain(*args, gbar),
                                    B * k * (5.0 * d + 9), in_bytes + 4.0 * B * (2 + d), sfu_bwd,
                                    max(max(e["g_theta"], e["g_m"]) for e in errs)),
    }
    return rows, timing


def check_top_k(device, sites):
    """The three top-k sites at the main path's shapes. Both exact ways of
    ``jax.lax.top_k``'s order (``index/knn.py``: a stable sort of the
    total-order keys; ``torch.topk`` over int64 keys with the column) on
    integer-valued distances, with many ties, must give a stable sort's
    first k indices; then, on Gaussian distances, the time of each and of
    the float ``torch.topk`` the port took before (no order among ties):
    CUDA events around the calls (host included) and their device time."""
    import torch

    from repro_torch.index import knn

    exact = {"by_sort": knn.smallest_k_by_sort, "by_topk": knn.smallest_k_by_topk}
    ways = {**exact, "float_topk": lambda t, k: torch.topk(t, k, dim=-1, largest=False)}
    out = {}
    for label, (shape, k) in sites.items():
        g = _gen(device, 400 + k)
        tied = torch.randint(0, 8, shape, generator=g, device=device).float()
        want = torch.sort(tied, dim=-1, stable=True).indices[..., :k]
        for name, fn in exact.items():
            if not torch.equal(fn(tied, k)[1], want):
                raise AssertionError(f"smallest_k_{name} at {label} {shape}: ties not in ascending index order")
        del tied, want
        d = torch.randn(shape, generator=g, device=device).abs()
        out[label] = {"shape": shape, "k": k, "ties_in_index_order": True,
                      **{f"{name}_ms": time_ms(lambda: fn(d, k)) for name, fn in ways.items()},
                      **{f"{name}_device_ms": device_ms(lambda: fn(d, k)) for name, fn in ways.items()}}
    return out


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def main_path(device):
    import torch

    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import registry

    cfg = main_config()
    t0 = time.time()
    x, _labels = gaussian_mixture(MAIN_N, cfg.dim, n_components=MAIN_COMPONENTS, seed=0)
    data_s = time.time() - t0

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    registry.reset_launch_counts()
    est = NomadProjection(cfg, device=device)
    res = est.fit(x)
    launches = registry.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None

    emb = res.embedding
    if emb.shape != (MAIN_N, cfg.out_dim) or not np.isfinite(emb).all():
        raise AssertionError(f"embedding not finite of shape {(MAIN_N, cfg.out_dim)}: {emb.shape}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"loss did not fall: {res.losses}")
    missing = [n for n in FIT_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # determinism: two short fits from one seed and one index are bit-equal
    short = cfg.replace(n_epochs=2)
    e1 = NomadProjection(short, device=device).fit(x, index=res.index).embedding
    e2 = NomadProjection(short, device=device).fit(x, index=res.index).embedding
    if not np.array_equal(e1, e2):
        raise AssertionError("two fits from one seed and index differ")
    profile = epoch_profile(device, cfg, res)
    quality = embedding_quality(x, emb, device)
    return {
        "config": {k: getattr(cfg, k) for k in (
            "n_points", "dim", "n_clusters", "n_neighbors", "n_noise",
            "n_exact_negatives", "batch_size", "kmeans_iters", "n_epochs")},
        "capacity": cfg.cluster_capacity,
        "steps_per_epoch": cfg.resolved_steps_per_epoch(),
        "reduced": REDUCED,
        "data_s": data_s,
        "stage_s": res.stage_s,
        "wall_s": res.wall_time_s,
        "epoch_s": res.epoch_times,
        "losses": res.losses,
        "stragglers": res.index_build_stragglers,
        "peak_device_gb": peak_gb,
        "launches": launches,
        "rerun_bit_equal": True,
        "epoch_profile": profile,
        "quality": quality,
    }, x, est, res


def embedding_quality(x, emb, device, n_queries=2000, k=10, seed=0):
    """The repo's quality metrics on a fit's embedding, through
    ``repro_torch.metrics``: NP@k over ``n_queries`` queries (exact blocked
    kNN on the card, both spaces) and random triplet accuracy over 20,000
    triplets."""
    from repro_torch.metrics import neighborhood_preservation, random_triplet_accuracy

    n = x.shape[0]
    np_k = neighborhood_preservation(x, emb, k=k, n_queries=n_queries, seed=seed, device=device)
    rta = random_triplet_accuracy(x, emb, 20_000, seed=seed)
    return {"np10": np_k, "np10_chance": k / n, "rta": rta, "n_queries": n_queries}


def epoch_profile(device, cfg, res):
    """One more epoch of the main path from the fitted θ: its wall time
    unprofiled, then under torch.profiler the device time of every kernel
    it ran. busy_share = device time / unprofiled wall (one stream)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.strategy import LocalStrategy

    theta0 = np.zeros((res.index.n_clusters * res.index.capacity, cfg.out_dim), np.float32)
    theta0[res.index.perm] = res.embedding
    strategy = LocalStrategy()
    theta = strategy.prepare(cfg, "nomad", res.index, theta0, device)
    lr = cfg.resolved_lr0() / cfg.n_epochs
    torch.cuda.synchronize()
    t0 = time.time()
    strategy.run_epoch(theta, 0, lr, lr)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        strategy.run_epoch(theta, 1, lr, lr)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "steps": cfg.resolved_steps_per_epoch(),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
        "top_kernels_ms": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in top],
    }


def small_quality(device):
    """The bands of tests/test_nomad_quality.py on its own small mixture,
    scored through ``repro_torch.metrics`` on the card: NP@10 > 10x chance,
    cluster purity of the low-dimensional neighbours > 0.9."""
    from repro_torch.configs import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.metrics import exact_knn, neighborhood_preservation

    cfg = NomadConfig(n_points=5000, dim=32, n_clusters=8, n_neighbors=15, n_noise=32,
                      n_exact_negatives=8, batch_size=512, n_epochs=25)
    x, labels = gaussian_mixture(5000, 32, n_components=8, seed=0)
    emb = NomadProjection(cfg, device=device).fit(x).embedding
    np10 = neighborhood_preservation(x, emb, k=10, n_queries=500, seed=0, device=device)
    q = np.random.default_rng(0).choice(5000, 500, replace=False)  # the metric's queries
    purity = float(np.mean(labels[exact_knn(emb, q, 10, device=device)] == labels[q, None]))
    if not (np10 > 10 * 10 / 5000 and purity > 0.9):
        raise AssertionError(f"small fit out of band: NP@10 {np10}, purity {purity}")
    return {"np10": np10, "purity": purity, "np10_floor": 10 * 10 / 5000, "purity_floor": 0.9}


# ---------------------------------------------------------------------------
# Phases 5 and 10: serving and the checkpoint round trip
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _mixture_centers(fit_seed, n_components, dim):
    from repro_torch.data.synthetic import mixture_centers

    return mixture_centers(np.random.default_rng(fit_seed), n_components, dim)


def mixture_queries(n, dim, n_components, seed, fit_seed=0, spread=0.15, labels=None):
    """New rows of the fit's mixture: the centres ``gaussian_mixture`` drew
    from ``fit_seed`` (drawn once, then kept: 4096 × 768 take ~0.1 s),
    fresh labels (or the given ``labels``) and noise from ``seed``."""
    centers = _mixture_centers(fit_seed, n_components, dim)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_components, n) if labels is None else labels
    return (centers[labels] + rng.normal(0, spread / np.sqrt(dim), (n, dim))).astype(np.float32)


def batch_profile(device, server, q):
    """One serving batch: its wall time unprofiled, then under
    torch.profiler the device time of every kernel it ran. busy_share =
    device time / unprofiled wall (one stream)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B = server.batch_rows
    args = (q[:B], np.arange(B), np.zeros(B, np.int64), np.ones(B, bool))
    server.transform_batch(*args)  # warm
    torch.cuda.synchronize()
    t0 = time.time()
    server.transform_batch(*args)
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.transform_batch(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "rows": B,
        "steps": server.steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
        "device_launches": sum(e.count for e in kernels),
        "top_kernels_ms": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in top],
    }


def serve_path(device, cfg, res, x):
    """``MapServer.transform`` of SERVE_Q new queries on the frozen main-path
    map, at serve_microbatch 1024 and transform_steps 24, with the serving
    kernels' launch counts read around it; then microbatch invariance,
    training rows as queries, and one batch profiled."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.kernels.pairwise.ops import allowed_error
    from repro_torch.serve import FrozenMap, MapServer

    t0 = time.time()
    fz = FrozenMap.from_fit(res, cfg, device=device)
    torch.cuda.synchronize()
    freeze_s = time.time() - t0
    q = mixture_queries(SERVE_Q, cfg.dim, MAIN_COMPONENTS, seed=1)
    server = MapServer(fz)
    torch.cuda.reset_peak_memory_stats(device)
    registry.reset_launch_counts()
    r = server.transform(q, seed=0)
    launches = registry.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if r.embedding.shape != (SERVE_Q, cfg.out_dim) or not np.isfinite(r.embedding).all():
        raise AssertionError(f"placements not finite of shape {(SERVE_Q, cfg.out_dim)}")
    missing = [n for n in SERVE_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")

    # microbatch invariance: the first queries at 512 and at 1024 rows a batch
    half = MapServer(fz, microbatch=512).transform(q[:INVARIANCE_Q], seed=0)
    if not np.array_equal(half.embedding, r.embedding[:INVARIANCE_Q]):
        bad = int(np.sum(np.any(half.embedding != r.embedding[:INVARIANCE_Q], axis=1)))
        raise AssertionError(f"placements differ between microbatch 512 and 1024 ({bad} rows)")

    # training rows as queries (tests/test_serve.py's criterion) — among the
    # first rows, those the capacity bound left in their nearest cell (a row
    # moved to another cell cannot find itself in its nearest one)
    cand = np.arange(400)
    rc = server.transform(x[cand], seed=0)
    home = res.index.perm[cand] // res.index.capacity
    take = cand[rc.cells == home][:50]
    if take.size < 50:
        raise AssertionError(f"only {take.size} of 400 rows sit in their nearest cell")
    rs = server.transform(x[take], seed=0)
    # self at distance ~0: K3 takes ‖q‖² + ‖x‖² − 2q·x in fp32, whose rounding
    # at D = 768 is of the order of its stated bound, not of the 1e-3 that
    # tests/test_serve.py holds at D = 16
    xt = torch.from_numpy(x[take])
    self_tol = np.sqrt(allowed_error(xt, xt).diagonal().numpy())
    found = rs.neighbor_ids[:, 0] == take
    near = rs.neighbor_dists[:, 0] <= self_tol
    if not (found.all() and near.all()):
        raise AssertionError(
            f"training rows sent as queries: {int(found.sum())}/{take.size} find themselves "
            f"first, {int(near.sum())} within K3's bound; max distance "
            f"{float(rs.neighbor_dists[:, 0].max())} against {float(self_tol.min())}"
        )
    r0 = MapServer(fz, steps=0).transform(x[take], seed=0)
    gap = np.linalg.norm(r0.embedding - res.embedding[take], axis=1)
    radius = np.array([np.linalg.norm(res.embedding[ids[ids >= 0]] - res.embedding[i], axis=1).max()
                       for i, ids in zip(take, r0.neighbor_ids)])
    if not (gap <= radius + 1e-12).all():
        raise AssertionError("steps=0 placements of training rows leave their neighbour radius")

    profile = batch_profile(device, server, q)
    return {
        "queries": SERVE_Q,
        "microbatch": server.microbatch,
        "steps": server.steps,
        "freeze_s": freeze_s,
        "wall_s": r.wall_time_s,
        "queries_per_s": SERVE_Q / r.wall_time_s,
        "p50_batch_s": r.p50_latency_s,
        "p99_batch_s": r.p99_latency_s,
        "first_batch_loss": r.batch_loss[0],
        "last_batch_loss": r.batch_loss[-1],
        "peak_device_gb": peak_gb,
        "launches": launches,
        "microbatch_512_equals_1024": True,
        "self_rows_checked": int(take.size),
        "self_max_dist": float(rs.neighbor_dists[:, 0].max()),
        "self_dist_bound_min": float(self_tol.min()),
        "self_rows_candidates_in_nearest_cell": int(np.sum(rc.cells == home)),
        "batch_profile": profile,
    }


def checkpoint_roundtrip(device):
    """The small fit (5000×32) with checkpoint_dir under chiprun_out/; then
    ``NomadProjection.from_checkpoint(dir).transform`` must be bit-equal to
    the fitted estimator's on the card, and the same checkpoint served on
    the CPU (the kernels' plain versions, the same per-row draws) must give
    the same cells, the same neighbour ids for at least 99% of the queries,
    and on those rows placements within 1e-3 × max(1, max |θ|): the two
    devices sum in other orders, and a swapped near-tie of two neighbours
    changes their rank weights."""
    import shutil

    from repro_torch.configs import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.synthetic import gaussian_mixture

    ckdir = os.path.join(OUT_DIR, "ckpt_small")
    shutil.rmtree(ckdir, ignore_errors=True)
    cfg = NomadConfig(n_points=5000, dim=32, n_clusters=8, n_neighbors=15, n_noise=32,
                      n_exact_negatives=8, batch_size=512, n_epochs=25, checkpoint_dir=ckdir)
    x, _ = gaussian_mixture(5000, 32, n_components=8, seed=0)
    q, _ = gaussian_mixture(2000, 32, n_components=8, seed=5)
    est = NomadProjection(cfg, device=device)
    fit = est.fit(x)
    a = est.map_server().transform(q, seed=0)
    b = NomadProjection.from_checkpoint(ckdir, device=device).map_server().transform(q, seed=0)
    for f in ("embedding", "cells", "neighbor_ids", "neighbor_dists"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"from_checkpoint transform differs from the fitted one in {f}")
    c = NomadProjection.from_checkpoint(ckdir, device="cpu").map_server().transform(q, seed=0)
    same_ids = np.all(a.neighbor_ids == c.neighbor_ids, axis=1)
    scale = max(1.0, float(np.abs(a.embedding).max()))
    err = float(np.abs(a.embedding[same_ids] - c.embedding[same_ids]).max())
    if not (np.array_equal(a.cells, c.cells) and same_ids.mean() >= 0.99 and err <= 1e-3 * scale):
        raise AssertionError(f"card vs CPU: cells equal {np.array_equal(a.cells, c.cells)}, "
                             f"ids equal on {same_ids.mean():.4f}, max |Δθ| {err} (scale {scale})")
    head = small_head_swap(device, est, fit, x, q, a, ckdir)
    writer = async_checkpoints(device, cfg, x, fit, ckdir)
    return {
        "checkpoint": "small fit (5000×32, K 8): the full-width 3.8 GB x_rows cache is not written",
        "async_writer": writer,
        "checkpoint_epochs": fit.checkpoint_epochs,
        "from_checkpoint_bit_equal": True,
        "cpu_cells_equal": True,
        "cpu_ids_equal_frac": float(same_ids.mean()),
        "cpu_max_abs_diff": err,
        "embedding_scale": scale,
        "inverse_swap": head,
    }


class StopFit(Exception):
    """Raised by a callback to interrupt a fit."""


def read_checkpoints(ckdir: str) -> dict:
    """Every step directory's manifest (its config's ``checkpoint_dir``
    dropped) and every array of every shard: what must agree between two
    writers (not the raw bytes: a zip entry carries its write time)."""
    out = {}
    for name in sorted(n for n in os.listdir(ckdir) if n.startswith("step_")):
        with open(os.path.join(ckdir, name, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["metadata"]["config"].pop("checkpoint_dir")
        files = {"manifest": manifest}
        for shard in sorted(n for n in os.listdir(os.path.join(ckdir, name)) if n.endswith(".npz")):
            with np.load(os.path.join(ckdir, name, shard)) as z:
                files[shard] = {k: z[k] for k in z.files}
        out[name] = files
    return out


def same_checkpoints(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[s].keys() == b[s].keys() and a[s]["manifest"] == b[s]["manifest"]
        and all(a[s][f].keys() == b[s][f].keys() and all(np.array_equal(a[s][f][k], b[s][f][k])
                                                           and a[s][f][k].dtype == b[s][f][k].dtype for k in a[s][f])
                for f in a[s] if f != "manifest")
        for s in a)


def async_checkpoints(device, cfg, x, fit, ckdir) -> dict:
    """The fit's asynchronous writer on the card (``fit`` saved through it
    into ``ckdir``): the same fit saved by a synchronous writer leaves the
    same checkpoints, array for array and in its manifests; a fit stopped
    right after a save returns (its write in flight) has committed that
    save, and ``fit(resume=True)`` from it is bit-equal to ``fit``."""
    import shutil

    import repro_torch.checkpoint as ck_mod
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.strategy import FitCallbacks

    made = []

    class Sync(ck_mod.Checkpointer):
        def __init__(self, directory, **kw):
            made.append(kw)
            super().__init__(directory, **dict(kw, async_save=False))

    sync_dir, stop_dir = ckdir + "_sync", ckdir + "_stopped"
    writer, ck_mod.Checkpointer = ck_mod.Checkpointer, Sync
    try:
        NomadProjection(cfg.replace(checkpoint_dir=sync_dir), device=device).fit(x)
    finally:
        ck_mod.Checkpointer = writer
    a, b = read_checkpoints(ckdir), read_checkpoints(sync_dir)
    if made != [{"n_shards": 1, "keep": 3, "async_save": True, "primary": True}] or not a or not same_checkpoints(a, b):
        raise AssertionError(f"async vs sync checkpoints differ (writer arguments {made}, steps {sorted(a)} / "
                             f"{sorted(b)})")
    stop_at = fit.checkpoint_epochs[len(fit.checkpoint_epochs) // 2]

    class Stop(FitCallbacks):
        wants_embedding = False

        def on_checkpoint(self, event):
            if event.epoch == stop_at:
                raise StopFit(event.epoch)

    try:
        NomadProjection(cfg.replace(checkpoint_dir=stop_dir), device=device).fit(x, callbacks=[Stop()])
        raise AssertionError("the fit ran past its stop")
    except StopFit:
        pass
    committed = ck_mod.latest_step(stop_dir)
    resumed = NomadProjection(cfg.replace(checkpoint_dir=stop_dir), device=device).fit(x, resume=True)
    if not (committed == stop_at and resumed.start_epoch == stop_at + 1
            and np.array_equal(resumed.embedding, fit.embedding)):
        raise AssertionError(f"stopped after the save of epoch {stop_at}: committed {committed}, resumed at "
                             f"{resumed.start_epoch}, equal {np.array_equal(resumed.embedding, fit.embedding)}")
    shutil.rmtree(sync_dir, ignore_errors=True)
    shutil.rmtree(stop_dir, ignore_errors=True)
    return {"steps_compared": sorted(a), "async_equal_sync": True, "stopped_after_save_of": stop_at,
            "committed_on_stop": committed, "resume_bit_equal_uninterrupted": True}


def small_head_swap(device, est, fit, x, q, served, ckdir):
    """The inverse head trained on the small fit on the card and saved
    beside its checkpoint; ``registry.swap(ckdir)`` must pick it up, serve
    ``project`` ≡ the fitted estimator's transform (``served``) and
    ``explore`` ≡ ``neighbors(decode(·))``, with a round-trip R² of at least
    the JAX package's floor."""
    from repro_torch.pipeline import inverse_from_frozen, roundtrip_score, save_inverse
    from repro_torch.service import MapService

    t0 = time.time()
    head = inverse_from_frozen(est.map_server().frozen)
    train_s = time.time() - t0
    save_inverse(ckdir, head)
    svc = MapService(device=device)
    try:
        svc.registry.add(est.map_server().frozen, version="fitted")
        h = svc.registry.swap(ckdir, version="loaded")
        if h.inverse is None or [d["version"] for d in svc.registry.versions()] != ["loaded"]:
            raise AssertionError("swap(ckdir) did not pick up inverse.npz, or kept the old version")
        if not _same_result(svc.project(q, seed=0).result, served):
            raise AssertionError("the swapped-in checkpoint serves other bits than the fitted estimator")
        coords = fit.embedding[:256]
        ex = svc.explore(coords)
        ids, dists = h.frozen.neighbors(h.inverse.decode(coords, device=device))
        if not (np.array_equal(ex.neighbor_ids, ids) and np.array_equal(ex.neighbor_dists, dists)):
            raise AssertionError("explore differs from neighbors(decode(coords)) on the swapped-in map")
        r2 = roundtrip_score(h.inverse, fit.embedding, x, device=device)
        if not r2 >= ROUNDTRIP_R2_FLOOR:
            raise AssertionError(f"round-trip R² {r2} under the floor {ROUNDTRIP_R2_FLOOR}")
    finally:
        svc.close()
    return {"train_s": train_s, "train_loss": head.train_loss, "roundtrip_r2": r2, "swap_picked_up_head": True,
            "project_equal_fitted": True, "explore_equal_neighbors_of_decode": True}


# ---------------------------------------------------------------------------
# Phase 6: growing the map in place (partial_fit)
# ---------------------------------------------------------------------------

PARTIAL_COMPONENTS = 2048  # the new rows come from the first half of the mixture's components
PARTIAL_PER_COMPONENT = 16  # M = 32,768 new rows
PARTIAL_KERNELS = FIT_KERNELS + SERVE_KERNELS[2:]  # all eight: place, split, kNN patch, refine
PARTIAL_REDUCED = REDUCED + [
    "appends: 32,768 new rows of the first 2,048 mixture components in one call (a feed appends in batches)",
]


def _cell_blocks_equal(a, b, C: int, cells: np.ndarray, slab: int = 256) -> np.ndarray:
    """For each cell of ``cells``, whether its C-row block of ``a`` equals
    that of ``b`` bit for bit; every cell below the largest is compared, a
    slab of ``slab`` cells at a time, so no full-size temporary exists."""
    n = int(cells.max()) + 1 if cells.size else 0
    eq = np.zeros(n, bool)
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        diff = np.asarray(a[lo * C : hi * C]) == np.asarray(b[lo * C : hi * C])
        eq[lo:hi] = np.all(diff.reshape(hi - lo, -1), axis=1)
    return eq[cells]


def check_grown_k(device, K: int) -> dict:
    """K1 (a refinement step: B 8192), K2 and K4 (a serving batch: B 1024)
    at a grown map's K' against their plain versions: K2 by its oracle
    rule, the others with atol scaled by the largest output as at K 4096."""
    import torch

    from repro_torch.kernels.cauchy_mean import ops as k4
    from repro_torch.kernels.kmeans_assign import ops as k2
    from repro_torch.kernels.nomad_step import ops as k1

    B, k, S, _, d = NOMAD_MAIN
    args = nomad_inputs(B, k, S, K, d, device, seed=K)
    gbar = torch.full((B,), 1.0 / B, device=device)
    e1 = _check_pair(f"nomad_step at K' {K}", nomad_pair(args, gbar), k1.TOL, True)
    g = _gen(device, K + 1)
    th, mu = torch.randn(1024, d, generator=g, device=device) * 3.0, torch.randn(K, d, generator=g, device=device) * 3.0
    w, own = torch.rand(K, generator=g, device=device), torch.randint(0, K, (1024,), generator=g, device=device,
                                                                       dtype=torch.int32)
    gb = torch.rand(1024, generator=g, device=device)
    outs = {"s": (k4.cauchy_mean_fwd_cuda(th, mu, w, own), k4.cauchy_mean_fwd_plain(th, mu, w, own)),
            "g_theta": (k4.cauchy_mean_bwd_cuda(th, mu, w, own, gb), k4.cauchy_mean_bwd_plain(th, mu, w, own, gb))}
    e4 = _check_pair(f"cauchy_mean at K' {K}", outs, k4.TOL, True)
    n, _, D = KMEANS_SERVE
    x, c = torch.randn(n, D, generator=g, device=device), torch.randn(K, D, generator=g, device=device)
    k2_got, k2_want = k2.assign_nearest_cuda(x, c), k2.assign_nearest_plain(x, c)
    torch.cuda.synchronize()
    k2.oracle_check(x, c, k2_got, k2_want)  # raises on disagreement
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"K": K, "nomad_step": {"shape": (B, k, S, K, d), "plan": k1.plan(K), "max_abs_err": e1},
            "kmeans_assign": {"shape": (n, K, D), "plan": k2.plan(n, K, sms),
                              "max_abs_err": _max_err(k2_got[1], k2_want[1])},
            "cauchy_mean": {"shape": (1024, K, d), "plan": k4.plan(K), "max_abs_err": e4}, "ok": True}


def check_served_k2(device, frozen, dim: int, seed: int) -> dict:
    """K2 as a full serving batch of the map runs it: ``serve_microbatch``
    mixture queries against the map's own centroids, on the card and in
    the plain version, by the oracle rule."""
    import torch

    from repro_torch.kernels.kmeans_assign import ops

    n = KMEANS_SERVE[0]
    q = torch.from_numpy(mixture_queries(n, dim, MAIN_COMPONENTS, seed=seed)).to(device)
    c = frozen.centroids
    got, want = ops.assign_nearest_cuda(q, c), ops.assign_nearest_plain(q, c)
    torch.cuda.synchronize()
    ops.oracle_check(q, c, got, want)  # raises on disagreement
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"shape": (n, c.shape[0], c.shape[1]), "plan": ops.plan(n, c.shape[0], sms),
            "max_abs_err": _max_err(got[1], want[1]),
            "argmin_equal_frac": float((got[0] == want[0]).float().mean()), "ok": True}


def check_split_cell(device, old, idx) -> dict:
    """K2 and K3 on one real split of the grow: the first original cell
    one of whose old rows moved to an appended cell, with every cell that
    holds its old rows (itself and its sub-cells). Their members against
    their centroids, on the card and in the plain versions, at the kernel
    phase's rules: K2's oracle rule, K3's scaled bound at D 768."""
    import torch

    from repro_torch.kernels.kmeans_assign import ops as k2
    from repro_torch.kernels.pairwise import ops as k3

    C, K, N = old.capacity, old.n_clusters, old.n_points
    cell_old, cell_new = np.asarray(old.perm) // C, np.asarray(idx.perm[:N]) // C
    moved = np.flatnonzero(cell_new >= K)
    if moved.size == 0:
        raise AssertionError("no old row moved to an appended cell: no split to check")
    c = int(cell_old[moved[0]])
    group = np.unique(np.concatenate([[c], cell_new[cell_old == c]]))
    mem = np.concatenate([np.asarray(idx.x_rows[g * C : g * C + int(idx.counts[g])]) for g in group])
    xd = torch.from_numpy(np.ascontiguousarray(mem, np.float32)).to(device)
    cd = torch.from_numpy(np.ascontiguousarray(idx.centroids[group], np.float32)).to(device)
    got, want = k2.assign_nearest_cuda(xd, cd), k2.assign_nearest_plain(xd, cd)
    d2, d2_plain = k3.pairwise_dist2_cuda(xd, cd), k3.pairwise_dist2_plain(xd, cd)
    torch.cuda.synchronize()
    k2.oracle_check(xd, cd, got, want)  # raises on disagreement
    if not bool(torch.all((d2 - d2_plain).abs() <= k3.allowed_error(xd, cd))):
        raise AssertionError(f"pairwise disagrees with its plain version on split cell {c}: "
                             f"{_max_err(d2, d2_plain)}")
    return {"cell": c, "sub_cells": group.tolist(), "shape": (int(mem.shape[0]), int(group.size), int(mem.shape[1])),
            "kmeans_assign_max_abs_err": _max_err(got[1], want[1]),
            "kmeans_assign_argmin_equal_frac": float((got[0] == want[0]).float().mean()),
            "pairwise_max_abs_err": _max_err(d2, d2_plain), "ok": True}


def partial_path(device, cfg, est, fit, x):
    """``est.partial_fit`` of M = 32,768 new rows on the main path's N = 1M
    map: the rows of the first 2,048 mixture components (16 each), so about
    half the cells stay untouched; ``cfg.partial_refine_epochs`` refinement
    epochs, no checkpoint_dir. Every kernel's launches are read around it.
    Fails unless all eight kernel entries launched, counts ≤ C, perm is a
    bijection onto the valid rows, x_rows[perm] equals x ∥ y, at least 30%
    of the original cells are untouched and each of them keeps its x_rows,
    kNN and θ rows bit for bit, and the new rows' embedding and the
    refinement losses are finite. Then K1 and K4 at K', and K2 and K3 on a
    real split cell, against their plain versions. map_stability and NP@10 of the old rows are reported, not
    gated (the 4-epoch map is near chance)."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.metrics import map_stability

    labels = np.repeat(np.arange(PARTIAL_COMPONENTS), PARTIAL_PER_COMPONENT)
    y = mixture_queries(labels.size, cfg.dim, MAIN_COMPONENTS, seed=3, labels=labels)
    N, M = x.shape[0], y.shape[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    registry.reset_launch_counts()
    pf = est.partial_fit(y, refine_epochs=cfg.partial_refine_epochs)
    launches = registry.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    t0 = time.time()
    missing = [n for n in PARTIAL_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the partial path: {missing}")
    old, idx = fit.index, pf.index
    C, K, K2 = old.capacity, old.n_clusters, idx.n_clusters
    if not (idx.capacity == C and (idx.counts <= C).all() and idx.n_points == N + M):
        raise AssertionError("grown index breaks capacity or the point count")
    perm = idx.perm
    valid = np.arange(K2 * C) % C < np.repeat(idx.counts, C)
    if not (perm.shape == (N + M,) and np.unique(perm).size == N + M and valid[perm].all()
            and int(valid.sum()) == N + M):
        raise AssertionError("perm is not a bijection onto the grown layout's valid rows")
    for s0 in range(0, N + M, 65_536):
        s1 = min(s0 + 65_536, N + M)
        want = x[s0:min(s1, N)] if s0 < N else y[s0 - N : s1 - N]
        if s0 < N < s1:
            want = np.concatenate([want, y[: s1 - N]])
        if not np.array_equal(idx.x_rows[perm[s0:s1]], want):
            raise AssertionError(f"x_rows[perm] differs from x ∥ y in rows [{s0}, {s1})")
    affected = np.asarray(pf.affected_cells)
    untouched = np.setdiff1d(np.arange(K), affected)
    if untouched.size < 0.3 * K:
        raise AssertionError(f"only {untouched.size} of {K} cells untouched (want >= 30%)")
    theta_old = np.zeros((K * C, cfg.out_dim), np.float32)
    theta_old[old.perm] = fit.embedding
    theta_new = np.zeros((K2 * C, cfg.out_dim), np.float32)
    theta_new[perm] = pf.embedding
    for label, a, b in (("x_rows", idx.x_rows, old.x_rows), ("knn_idx", idx.knn_idx, old.knn_idx),
                        ("knn_w", idx.knn_w, old.knn_w), ("theta", theta_new, theta_old)):
        same = _cell_blocks_equal(a, b, C, untouched)
        if not same.all():
            raise AssertionError(f"{label}: {int((~same).sum())} untouched cells changed")
    if not (np.isfinite(pf.embedding[N:]).all() and np.isfinite(pf.losses).all()):
        raise AssertionError("new rows' embedding or refinement losses not finite")
    checks_s = time.time() - t0

    grown_k = check_grown_k(device, K2)
    split_cell = check_split_cell(device, old, idx) if pf.n_split_cells else None
    stability = map_stability(fit.embedding, pf.embedding[:N], k=10, n_queries=2000, seed=0, device=device)
    quality = embedding_quality(x, pf.embedding[:N], device)
    return {
        "new_rows": M,
        "components": PARTIAL_COMPONENTS,
        "refine_epochs": pf.refine_epochs,
        "reduced": PARTIAL_REDUCED,
        "K": K,
        "K_grown": K2,
        "n_split_cells": pf.n_split_cells,
        "n_new_cells": pf.n_new_cells,
        "affected_cells": int(affected.size),
        "affected_points": int(idx.counts[affected].sum()),
        "untouched_cells": int(untouched.size),
        "refine_steps_per_epoch": -(-int(idx.counts[affected].sum()) // cfg.batch_size),
        "stage_s": pf.stage_s,
        "wall_s": pf.wall_time_s,
        "epoch_s": pf.epoch_times,
        "losses": pf.losses,
        "peak_device_gb": peak_gb,
        "launches": launches,
        "untouched_bit_identical": True,
        "checks_s": checks_s,
        "grown_k_kernels": grown_k,
        "split_cell_kernels": split_cell,
        "map_stability_old_rows": stability,
        "old_rows_quality": quality,
    }


def partial_small(device):
    """partial_fit at the small fit's size (5000×32, K 8) on the card:
    place-only ≡ ``MapServer.transform`` bit for bit; two partial fits from
    one base bit-equal; the lineage fit → v1 → ``from_checkpoint(root).
    partial_fit`` → v2 (parent v1), whose directory serves bit-equal to the
    estimator; a store-backed fit and grow (chunk_rows set, float32 store)
    ≡ the array's; the kNN patch in blocks of cells ≡ one batch; and NP@10
    of the old rows ≥ a joint refit's − 0.05 (tests/test_partial_fit.py's
    band)."""
    import shutil

    import torch

    from repro_torch.checkpoint import MapLineage
    from repro_torch.configs import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.store import write_sharded
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.index.build import chunked_cluster_knn
    from repro_torch.metrics import neighborhood_preservation
    from repro_torch.serve import FrozenMap, MapServer
    from repro_torch.service import MapService

    work = os.path.join(OUT_DIR, "partial_small")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = NomadConfig(n_points=5000, dim=32, n_clusters=8, n_neighbors=15, n_noise=32,
                      n_exact_negatives=8, batch_size=512, n_epochs=25)
    x, _ = gaussian_mixture(5000, 32, n_components=8, seed=0)
    y, _ = gaussian_mixture(1200, 32, n_components=8, seed=6)
    y2, _ = gaussian_mixture(700, 32, n_components=8, seed=7)
    q, _ = gaussian_mixture(1000, 32, n_components=8, seed=8)
    out = {}
    try:
        est = NomadProjection(cfg, device=device)
        base = est.fit(x)
        want = est.map_server().transform(y, seed=3).embedding
        placed = est.partial_fit(y, refine_epochs=0, seed=3)
        if not (np.array_equal(placed.embedding[5000:], want) and np.array_equal(placed.embedding[:5000],
                                                                                  base.embedding)):
            raise AssertionError("partial_fit(refine_epochs=0) differs from MapServer.transform")
        out["place_only_equals_transform"] = True

        root = os.path.join(work, "lineage")
        est_a = NomadProjection(cfg, device=device)
        est_a.fit(x)
        pf_a = est_a.partial_fit(y)
        est_b = NomadProjection(cfg.replace(checkpoint_dir=root), device=device)
        est_b.fit(x)
        want_v0 = est_b.map_server().transform(q, seed=0)
        pf_b = est_b.partial_fit(y)
        if not (np.array_equal(pf_a.embedding, pf_b.embedding) and np.array_equal(pf_a.index.perm, pf_b.index.perm)
                and pf_a.losses == pf_b.losses):
            raise AssertionError("two partial fits from one base differ")
        out["deterministic"] = True
        out.update(n_split_cells=pf_a.n_split_cells, n_new_cells=pf_a.n_new_cells,
                   affected_cells=int(pf_a.affected_cells.size), stage_s=pf_a.stage_s, losses=pf_a.losses)

        cold = NomadProjection.from_checkpoint(root, device=device)
        pf2 = cold.partial_fit(y2)
        versions = MapLineage(root).load()
        if not ([v.name for v in versions] == ["v0", "v1", "v2"] and versions[2].parent == "v1"
                and pf2.parent_version == "v1" and [v.n_points for v in versions] == [5000, 6200, 6900]):
            raise AssertionError(f"lineage not chained: {[v.to_json() for v in versions]}")
        served = MapServer(FrozenMap.from_checkpoint(versions[2].path, device=device)).transform(q, seed=0)
        if not np.array_equal(served.embedding, cold.transform(q, seed=0)):
            raise AssertionError("the v2 directory's transform differs from the estimator's")
        out["lineage"] = [v.to_json() for v in versions]
        svc = MapService(device=device)
        try:  # the service serves the lineage's first and newest versions
            newest = svc.registry.load_lineage(root)
            first = svc.registry.load_lineage(root, map_version="v0", activate=False)
            if not (newest.version == "v2" and first.version == "v0"
                    and _same_result(svc.project(q, seed=0).result, cold.map_server().transform(q, seed=0))
                    and _same_result(svc.project(q, seed=0, map_version="v0").result, want_v0)):
                raise AssertionError("load_lineage: v0 or v2 serves other bits than the estimator at that version")
        finally:
            svc.close()
        out["load_lineage_v0_v2_equal_estimator"] = True

        chunked = cfg.replace(chunk_rows=1024)
        store = os.path.join(work, "store")
        write_sharded(x, store, rows_per_shard=1500)
        est_s = NomadProjection(chunked.replace(checkpoint_dir=os.path.join(work, "ck_store")), device=device)
        est_s.fit(store)
        est_m = NomadProjection(chunked, device=device)
        est_m.fit(x)
        ps, pm = est_s.partial_fit(y), est_m.partial_fit(y)
        same = np.array_equal(ps.embedding, pm.embedding) and np.array_equal(
            ps.index.x_rows.materialize(), np.asarray(pm.index.x_rows))
        for f in ("perm", "counts", "centroids", "knn_idx", "knn_w"):
            same &= np.array_equal(getattr(ps.index, f), getattr(pm.index, f))
        if not (same and type(ps.index.x_rows).__name__ == "ShardedStore"):
            raise AssertionError("store-backed fit and grow differ from the array's")
        out["store_equals_array"] = True

        K2, C = pf_a.index.n_clusters, pf_a.index.capacity
        blocks = list(np.asarray(pf_a.index.x_rows).reshape(K2, C, -1))
        one = chunked_cluster_knn(blocks, pf_a.index.counts, cfg.n_neighbors, device, cells_per_launch=K2)
        few = chunked_cluster_knn(blocks, pf_a.index.counts, cfg.n_neighbors, device, cells_per_launch=3)
        if not (np.array_equal(one[0], few[0]) and np.array_equal(one[1], few[1])):
            raise AssertionError("the kNN patch in blocks of 3 cells differs from one batch")
        out["knn_blocks_equal_one_batch"] = True

        joint = NomadProjection(cfg.replace(n_points=6200), device=device).fit(np.vstack([x, y]))
        np_partial = neighborhood_preservation(x, pf_a.embedding[:5000], k=10, n_queries=500, device=device)
        np_joint = neighborhood_preservation(x, joint.embedding[:5000], k=10, n_queries=500, device=device)
        if not np_partial >= np_joint - 0.05:
            raise AssertionError(f"NP@10 of the old rows {np_partial} below the joint refit's {np_joint} - 0.05")
        out.update(np10_old_rows=np_partial, np10_joint=np_joint)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the map service (batcher, cache, registry, hot swap, explore)
# ---------------------------------------------------------------------------

SERVICE_CLIENTS = (1, 8, 32)
SERVICE_REQUESTS = 200  # requests of one load run, at least (a client sends 16 at least)
SERVICE_ROWS = 64  # rows a request, ± 2 (benchmarks/service_load.py's jitter)
SERVICE_CACHE_EVERY = 10  # request i (i > 0, i % 10 == 0) repeats the client's first: a cache hit
SWAP_CLIENTS = 8
SWAP_V1_CHECKED = 64  # v1 responses of the swap held to a direct transform
EXPLORE_ROWS = 1024
DECODE_TOL = 1e-6  # the card's decode against the CPU's: fp32 reads ~2e-8, a TF32 decode far more
ROUNDTRIP_ROWS = 20_000
ROUNDTRIP_R2_FLOOR = 0.15  # the JAX package's floor (tests/test_pipeline.py), at the small fit


def serve_launches_per_batch(cfg) -> dict:
    """Launches of one serving batch of ``serve_microbatch`` rows: K2 once,
    K3 once a ``serve_knn_block`` of queries, K4f/K4b/K5f/K5b once a step."""
    per = {n: 0 for n in FIT_KERNELS + SERVE_KERNELS[2:]}
    per.update(kmeans_assign=1, pairwise=-(-cfg.serve_microbatch // cfg.serve_knn_block))
    for n in SERVE_KERNELS[2:]:
        per[n] = cfg.transform_steps
    return per


def requests_per_client(n_clients: int) -> int:
    """16, or more so that the run sends ``SERVICE_REQUESTS`` in all: a
    p99 of fewer requests would be little more than their maximum."""
    return max(16, -(-SERVICE_REQUESTS // n_clients))


def client_schedule(n_clients, dim, seed0):
    """Each client's requests, drawn before the clients start:
    ``requests_per_client`` of 64 ± 2 rows of the fit's mixture, a seed
    each; every 10th request repeats request 0."""
    out = []
    for c in range(n_clients):
        reqs = []
        for i in range(requests_per_client(n_clients)):
            if i and i % SERVICE_CACHE_EVERY == 0:
                reqs.append(reqs[0])
            else:
                s = seed0 + 1000 * c + i
                reqs.append((mixture_queries(SERVICE_ROWS + i % 5 - 2, dim, MAIN_COMPONENTS, seed=s), s))
        out.append(reqs)
    return out


def drive_clients(svc, schedule, stop=None, after_stop=2):
    """One thread a client, each sending its requests in turn through
    ``MapService.project``. With ``stop`` (an Event), a client cycles
    through its rows with fresh seeds until ``stop`` is set, then sends
    ``after_stop`` more. Returns each client's [(q, seed, outcome, wall,
    sent after stop)] and the run's wall; any error is raised."""
    import threading

    got = [[] for _ in schedule]
    errs = []
    start = threading.Barrier(len(schedule) + 1)

    def client(c):
        try:
            start.wait()
            reqs, i, tail = schedule[c], 0, 0
            while (i < len(reqs)) if stop is None else (tail < after_stop and i < 10_000):
                q, seed = reqs[i % len(reqs)]
                if stop is not None:
                    seed = 900_000 + 10_000 * c + i
                late = stop is not None and stop.is_set()
                t0 = time.perf_counter()
                out = svc.project(q, seed=seed)
                got[c].append((q, seed, out, time.perf_counter() - t0, late))
                i += 1
                tail += late
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(schedule))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client did not finish within 600 s")
    return got, wall


def device_breakdown(device, fn, top: int = 0):
    """``fn()`` under torch.profiler: (its wall s, the device's kernel time
    s, the ``top`` kernels by device time as (name, ms, calls)). Only the
    device's activity is recorded: nothing here reads the host's events,
    and the profiler sorts a call of ~10^5 kernels out in a fraction of
    the time it takes with them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return wall, busy / 1e6, [(e.key[:120], e.self_device_time_total / 1e3, e.count) for e in ranked]


def device_busy(device, fn):
    """``fn()`` under torch.profiler: (its wall s, the device's kernel time s)."""
    return device_breakdown(device, fn)[:2]


def _same_result(got, want) -> bool:
    return all(np.array_equal(getattr(got, f), getattr(want, f))
               for f in ("embedding", "cells", "neighbor_ids", "neighbor_dists"))


def service_load(svc, handle, cfg, n_clients, seed0, per_batch):
    """One load run of ``n_clients`` clients on the active map: request
    latency, rows/s, batches, fill, hits and each kernel's launches, which
    must equal the run's device batches × one batch's count. The repeats
    must be cache hits that never reach the batcher."""
    from repro_torch.kernels import registry

    schedule = client_schedule(n_clients, cfg.dim, seed0)
    n_req = requests_per_client(n_clients)
    st0, hits0 = handle.batcher.stats.as_dict(), svc.cache.hits
    registry.reset_launch_counts()
    got, wall = drive_clients(svc, schedule)
    launches = registry.launch_counts()
    st1 = handle.batcher.stats.as_dict()
    n_batches = st1["n_batches"] - st0["n_batches"]
    n_rows = st1["n_rows"] - st0["n_rows"]
    hits = svc.cache.hits - hits0
    miss_rows = sum(o.result.n_queries for rs in got for _, _, o, _, _ in rs if not o.cache_hit)
    repeats = [(rs[0][2], rs[i][2]) for rs in got for i in range(SERVICE_CACHE_EVERY, n_req, SERVICE_CACHE_EVERY)]
    if not all(b.cache_hit and b.result is a.result for a, b in repeats) or hits != len(repeats):
        raise AssertionError(f"{n_clients} clients: {hits} cache hits, want the {len(repeats)} repeats")
    if n_rows != miss_rows or st1["n_requests"] - st0["n_requests"] != n_clients * n_req - hits:
        raise AssertionError(f"{n_clients} clients: the batcher saw {n_rows} rows, the misses hold {miss_rows}")
    want = {n: n_batches * c for n, c in per_batch.items()}
    if launches != want:
        raise AssertionError(f"{n_clients} clients: launches {launches}, want {n_batches} batches × one "
                             f"batch's {per_batch}")
    for rs in got:
        for q, _, o, _, _ in rs:
            if o.result.embedding.shape != (q.shape[0], cfg.out_dim) or not np.isfinite(o.result.embedding).all():
                raise AssertionError(f"{n_clients} clients: a response is not finite of shape {q.shape[0]}×2")
    walls = [w for rs in got for _, _, _, w, _ in rs]
    rows = sum(q.shape[0] for rs in got for q, _, _, _, _ in rs)
    return got, {
        "clients": n_clients,
        "requests": len(walls),
        "rows": rows,
        "wall_s": wall,
        "request_p50_s": float(np.percentile(walls, 50)),
        "request_p99_s": float(np.percentile(walls, 99)),
        "request_max_s": max(walls),
        "rows_per_s": rows / wall,  # cache hits' rows included
        "device_rows_per_s": n_rows / wall,  # the rows that reached the device
        "n_batches": n_batches,
        "batch_fill": n_rows / (n_batches * handle.server.batch_rows),
        "cache_hits": hits,
        "launches": launches,
    }


def service_path(device, cfg, fit, est, x):
    """The service (``repro_torch.service``) on the main path's N = 1M map at
    PubMed's serve widths (microbatch 1024, 24 steps, k 15, S 16, a 5 ms
    batching delay, 1024 cache entries): the inverse head trained on the
    map on the card; load runs of 1, 8 and 32 clients (launches = device
    batches × one batch's counts, repeats served by the cache); the 8
    clients' responses ≡ a direct ``MapServer.transform`` each; explore of
    1,024 training rows ≡ ``FrozenMap.neighbors(decode(·))`` with the card's
    decode within ``DECODE_TOL`` of the CPU's and a TF32 decode beyond it;
    the 32-client run again under torch.profiler for the busy share; then a
    hot swap to the grown map (``est``'s, from partial_path) under 8
    clients: nothing dropped, every response ≡ a direct transform on the
    version it names. K2 on each version's own centroids at a full serving
    batch, against its plain version."""
    import threading

    import torch

    from repro_torch.kernels import registry
    from repro_torch.pipeline import inverse_from_frozen, roundtrip_score
    from repro_torch.serve import FrozenMap, MapServer
    from repro_torch.service import MapService

    out = {"config": {"serve_microbatch": cfg.serve_microbatch, "transform_steps": cfg.transform_steps,
                      "n_neighbors": cfg.n_neighbors, "n_exact_negatives": cfg.n_exact_negatives,
                      "service_max_delay_s": cfg.service_max_delay_s,
                      "service_cache_entries": cfg.service_cache_entries}}
    per_batch = serve_launches_per_batch(cfg)
    out["launches_per_batch"] = per_batch
    t0 = time.time()
    fz = FrozenMap.from_fit(fit, cfg, device=device)
    torch.cuda.synchronize(device)
    out["freeze_s"] = time.time() - t0

    # the inverse head on the card, from the map's own rows
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"TF32 matmuls are on: the head's decode would leave the CPU's by more than "
                             f"{DECODE_TOL}")
    t0 = time.time()
    head = inverse_from_frozen(fz, hidden=(128, 128), steps=1500)
    torch.cuda.synchronize(device)
    train_s = time.time() - t0
    pick = np.sort(np.random.default_rng(11).choice(x.shape[0], ROUNDTRIP_ROWS, replace=False))
    r2 = roundtrip_score(head, fit.embedding[pick], x[pick], device=device)
    out["inverse"] = {"hidden": list(head.hidden), "steps": head.train_steps, "train_s": train_s,
                      "train_loss": head.train_loss, "roundtrip_r2_20k": r2}
    print(json.dumps({"service_inverse": out["inverse"]}), flush=True)

    svc = MapService(cache_entries=cfg.service_cache_entries, device=device)
    try:
        t0 = time.time()
        v1 = svc.registry.add(fz, version="v1", inverse=head)
        out["add_v1_s"] = time.time() - t0
        if v1.batcher.max_delay_s != cfg.service_max_delay_s:
            raise AssertionError(f"batcher delay {v1.batcher.max_delay_s} is not the config's")
        out["k2_served"] = {"v1": check_served_k2(device, fz, cfg.dim, seed=41)}

        # 1. load runs; 2. the 8 clients' responses ≡ direct transforms
        direct = MapServer(fz)
        runs, service_launches = [], {n: 0 for n in per_batch}
        for n_clients in SERVICE_CLIENTS:
            got, run = service_load(svc, v1, cfg, n_clients, 10_000 * n_clients, per_batch)
            for n, c in run["launches"].items():
                service_launches[n] += c
            if n_clients == SWAP_CLIENTS:
                t0 = time.time()
                misses = [(q, s, o) for rs in got for q, s, o, _, _ in rs if not o.cache_hit]
                bad = sum(not _same_result(o.result, direct.transform(q, seed=s)) for q, s, o in misses)
                if bad:
                    raise AssertionError(f"{bad} of {len(misses)} coalesced responses differ from a direct transform")
                run["coalesced_equal_direct"] = len(misses)
                run["direct_check_s"] = time.time() - t0
            runs.append(run)
            print(json.dumps({"service_load": run}), flush=True)
        out["load"] = runs
        out["launches"] = service_launches

        # 4. explore at full width: ≡ neighbors(decode(·)), decode card ≈ CPU
        coords = fit.embedding[pick[:EXPLORE_ROWS]]
        registry.reset_launch_counts()
        ex = svc.explore(coords, map_version="v1")
        ex_launches = registry.launch_counts()
        dec = head.decode(coords, device=device)
        ids, dists = fz.neighbors(dec)
        if not (np.array_equal(ex.embedding, dec) and np.array_equal(ex.neighbor_ids, ids)
                and np.array_equal(ex.neighbor_dists, dists)):
            raise AssertionError("explore differs from FrozenMap.neighbors(decode(coords))")
        want = {n: 0 for n in per_batch}
        want.update(kmeans_assign=1, pairwise=-(-EXPLORE_ROWS // cfg.serve_knn_block))
        if ex_launches != want:
            raise AssertionError(f"explore's launches {ex_launches}, want {want}")
        dec_cpu = head.decode(coords, device="cpu")
        dec_err = float(np.abs(dec - dec_cpu).max())
        # the same decode with TF32 on (no client is running): the bound
        # must lie between the sound reading and this one
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_err = float(np.abs(head.decode(coords, device=device) - dec_cpu).max())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        if not dec_err <= DECODE_TOL < tf32_err:
            raise AssertionError(f"the card's decode is {dec_err} from the CPU's, a TF32 decode {tf32_err} "
                                 f"(want <= {DECODE_TOL} < TF32's)")
        ex_walls = [svc.explore(coords, map_version="v1").wall_s for _ in range(10)]
        out["explore"] = {"rows": EXPLORE_ROWS, "equal_neighbors_of_decode": True, "launches": ex_launches,
                          "decode_card_vs_cpu_max_abs": dec_err, "decode_tf32_vs_cpu_max_abs": tf32_err,
                          "decode_tol": DECODE_TOL, "p50_s": float(np.percentile(ex_walls, 50)),
                          "walls_s": ex_walls}
        print(json.dumps({"service_explore": out["explore"]}), flush=True)

        # the busy share of a 32-client run (a second one, profiled)
        sched = client_schedule(SERVICE_CLIENTS[-1], cfg.dim, 500_000)
        st0 = v1.batcher.stats.n_batches
        wall, busy = device_busy(device, lambda: drive_clients(svc, sched))
        out["profiled_32"] = {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
                              "n_batches": v1.batcher.stats.n_batches - st0}
        print(json.dumps({"service_profiled": out["profiled_32"]}), flush=True)

        # 3. hot swap to the grown map under 8 clients
        pool = client_schedule(SWAP_CLIENTS, cfg.dim, 700_000)
        stop = threading.Event()
        result = {}

        def swap():
            """Half a second into the load: freeze the grown map, add it as
            v2 (warm, then active), retire v1; the clients then send two
            more requests each."""
            try:
                time.sleep(0.5)
                t0 = time.time()
                grown = FrozenMap.from_fit(est._fit_result, cfg, device=device)
                result["v2"] = svc.registry.add(grown, version="v2")
                svc.registry.retire("v1")
                result["swap_s"] = time.time() - t0
            except BaseException as e:  # noqa: BLE001
                result["error"] = e
            finally:
                stop.set()

        st0 = v1.batcher.stats.n_batches
        registry.reset_launch_counts()
        swapper = threading.Thread(target=swap)
        swapper.start()
        got, wall = drive_clients(svc, pool, stop=stop)
        swapper.join()
        launches = registry.launch_counts()
        if "error" in result:
            raise result["error"]
        v2 = result["v2"]
        if svc.registry.active_version != "v2" or [d["version"] for d in svc.registry.versions()] != ["v2"]:
            raise AssertionError(f"after the swap: {svc.registry.versions()}")
        v1_batches, v2_batches = v1.batcher.stats.n_batches - st0, v2.batcher.stats.n_batches
        # the warm-up of v2 is one more batch through the same path
        want = {n: (v1_batches + v2_batches + 1) * c for n, c in per_batch.items()}
        if launches != want:
            raise AssertionError(f"swap: launches {launches}, want ({v1_batches} + {v2_batches} + 1 warm) × "
                                 f"{per_batch}")
        out["k2_served"]["v2"] = check_served_k2(device, v2.frozen, cfg.dim, seed=42)
        print(json.dumps({"service_k2_served": out["k2_served"]}), flush=True)
        flat = [r for rs in got for r in rs]
        late_v1 = [r for r in flat if r[4] and r[2].map_version != "v2"]
        if late_v1 or any(len(rs) < 2 for rs in got):
            raise AssertionError(f"{len(late_v1)} requests sent after the swap served by v1")
        by_version = {"v1": [r for r in flat if r[2].map_version == "v1"],
                      "v2": [r for r in flat if r[2].map_version == "v2"]}
        if len(by_version["v1"]) + len(by_version["v2"]) != len(flat) or not by_version["v2"]:
            raise AssertionError("swap: responses of neither version, or none of v2")
        t0 = time.time()
        servers = {"v1": direct, "v2": MapServer(v2.frozen)}
        checked = {"v1": by_version["v1"][:SWAP_V1_CHECKED], "v2": by_version["v2"]}
        for name, rs in checked.items():
            bad = sum(not _same_result(o.result, servers[name].transform(q, seed=s)) for q, s, o, _, _ in rs)
            if bad:
                raise AssertionError(f"swap: {bad} of {len(rs)} {name} responses differ from a direct transform")
        walls = [r[3] for r in flat]
        out["swap"] = {
            "clients": SWAP_CLIENTS, "requests": len(flat), "wall_s": wall, "swap_s": result["swap_s"],
            "v1_responses": len(by_version["v1"]), "v2_responses": len(by_version["v2"]),
            "checked": {k: len(v) for k, v in checked.items()}, "direct_check_s": time.time() - t0,
            # a swap window holds ~100 requests: their maximum, not a p99
            "request_p50_s": float(np.percentile(walls, 50)), "request_max_s": max(walls),
            "v1_batches": v1_batches, "v2_batches": v2_batches, "launches": launches,
            "K_v2": v2.frozen.n_clusters, "fingerprints": [v1.fingerprint, v2.fingerprint],
            "v1_errors": v1.batcher.stats.n_errors, "v2_errors": v2.batcher.stats.n_errors,
            "swap_retries": svc.metrics.count("project.swap_retries"),
        }
        if out["swap"]["v1_errors"] or out["swap"]["v2_errors"]:
            raise AssertionError(f"batcher errors during the swap: {out['swap']}")
        print(json.dumps({"service_swap": out["swap"]}), flush=True)
        out["metrics"] = {k: v for k, v in svc.metrics_snapshot().items() if k != "maps"}
    finally:
        svc.close()
    del fz
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the pipeline (embed a corpus with Phi-4-mini, map, serve, explore)
# ---------------------------------------------------------------------------

PIPE_ARCH = "phi4-mini-3.8b"
PIPE_WORKLOAD = "pipeline_phi4_mini"
PIPE_DOCS = 16_384
PIPE_SEQ = 128
PIPE_CLASSES = 8
PIPE_DOC_BATCH = 128
PIPE_EQUIV_DOCS = 2_048  # streamed ≡ materialized, and a second embed, on the first documents
PIPE_EQUIV_CHUNK = 512  # chunk_rows of that check's two fits
PIPE_HELD_OUT = 1_024  # documents of class_token_corpus(seed=1), placed through MapService
PIPE_FIT = dict(n_clusters=64, batch_size=2_048, chunk_rows=4_096)
PIPE_AGREEMENT_K = 10
PIPE_AGREEMENT_MIN = 3.0 / PIPE_CLASSES  # 0.375: three times chance
FWD_ARCHS = ("phi4-mini-3.8b", "mamba2-2.7b", "mixtral-8x7b")
FWD_LAYERS = 2
FWD_DOCS = 4
# card fp32 against the CPU's fp32 forward, each token's ‖Δh‖/‖h‖ after the
# final norm: both sum in float32 over D = 2560-14336 terms in other orders
# (~√D · 2^-24 ≈ 1e-5 a product), through two layers
FWD_FP32_REL = 1e-4
# the bf16 forward against the fp32 one on the card, each token's
# ‖Δh‖/‖h‖: bf16 keeps 8 bits (unit roundoff 2^-9 ≈ 0.002) and rounds the
# activations at every product and norm, ~10 times a layer. A token whose
# MoE route flipped between the two is a different discrete decision; so
# is every later token of its document, and a token whose capacity slot
# was won or lost. The median takes all tokens; the max, and the fp32
# comparison, take each document's tokens before its first such decision
# (at least one token in all, or the check fails)
FWD_BF16_REL_MEDIAN = 0.03
FWD_BF16_REL_MAX = 0.1
# a routing decision that differs between the card's fp32 and the CPU's
# must be a near-tie: the two experts' probabilities within this
ROUTE_TIE = 1e-5
PIPELINE_REDUCED = [
    "head_pad_to 16 -> 1, vocab_pad_to 256 -> 1: one card has no tensor axis to divide, so no inert "
    "heads or vocabulary columns (a layout, not a cut)",
    "weights: random from a seeded torch.Generator (bf16), not the published checkpoint",
    f"corpus: class_token_corpus ({PIPE_DOCS:,} documents x {PIPE_SEQ} tokens, {PIPE_CLASSES} classes) "
    "in place of a text corpus",
    f"forward checks: {FWD_LAYERS} of the published layers, {FWD_DOCS} documents",
]


def pipeline_arch():
    """Phi-4-mini at its published widths, heads and vocabulary unpadded."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[PIPE_ARCH], head_pad_to=1, vocab_pad_to=1)
    want = dict(n_layers=32, d_model=3072, n_heads=24, head_dim=128, n_kv_heads=8, d_ff=8192,
                vocab_size=200_064, param_dtype="bfloat16", compute_dtype="bfloat16", attn_chunk=1024)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"{PIPE_ARCH} is not at its published widths: {got}")
    return cfg


def dense_matmul_flops(cfg, seq: int) -> float:
    """A dense model's matmul FLOPs a token of a ``seq``-token document: the
    q/k/v/o projections, the SwiGLU and the full (Sq × Sk) score and value
    products, 2 a multiply-add; the embedding gather is none."""
    D, hd = cfg.d_model, cfg.head_dim
    proj = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * D
    attn = 2 * seq * cfg.n_heads * hd
    return float(cfg.n_layers * 2 * (proj + 3 * D * cfg.d_ff + attn))


def hidden_with_routes(model, cfg, toks):
    """``hidden_states`` of ``toks`` in float32, and every MoE routing
    decision the forward made (``moe.route_hook``): (probs, expert ids,
    keep) of each call, on the host."""
    from repro_torch.data.embeddings import hidden_states
    from repro_torch.models import moe

    routes = []
    with moe.route_hook(lambda p, i, k: routes.append((p.float().cpu(), i.cpu(), k.cpu()))):
        h = hidden_states(model, cfg, tokens=toks).float()
    return h, routes


def route_diffs(a, b, docs: int, seq: int):
    """Where two runs' routes part: the tokens whose expert ids differ, each
    one's largest probability gap in run b between the experts chosen, and
    a (docs, seq) mask of each document's tokens before the first position
    at which any call's ids or capacity keeps differ. Up to there a token's
    hidden state is the same function of the same inputs in both runs:
    attention and the SSM are causal, and an expert's output for a kept
    token depends on that token alone."""
    import torch

    first, flips, gaps = torch.full((docs,), seq), 0, []
    for (_, ia, ka), (pb, ib, kb) in zip(a, b):
        flip = (ia != ib).any(-1)
        flips += int(flip.sum())
        gaps += [float((pb[t, ia[t]] - pb[t, ib[t]]).abs().max()) for t in flip.nonzero().squeeze(1).tolist()]
        part = (flip | (ka != kb).any(-1)).reshape(docs, seq)
        first = torch.minimum(first, torch.where(part, torch.arange(seq), seq).amin(-1))
    return flips, gaps, torch.arange(seq)[None, :] < first[:, None]


def forward_check(device, name: str) -> dict:
    """``name`` at its published widths with ``FWD_LAYERS`` layers, fp32:
    the card's ``hidden_states`` of ``FWD_DOCS`` documents against the
    port's CPU forward (``FWD_FP32_REL``; routing decisions compared, each
    difference a near-tie), then the bf16 forward of the same weights
    against the fp32 one on the card (``FWD_BF16_REL_*``). The maxima take
    the tokens :func:`route_diffs` leaves in common."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import class_token_corpus
    from repro_torch.models import lm

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the card's fp32 forward would not be fp32")
    cfg = dataclasses.replace(ARCHS[name], n_layers=FWD_LAYERS, head_pad_to=1, vocab_pad_to=1,
                              param_dtype="float32", compute_dtype="float32")
    toks, _ = class_token_corpus(FWD_DOCS, PIPE_SEQ, cfg.vocab_size, n_classes=PIPE_CLASSES, seed=2)
    model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(1))
    h_card, r_card = hidden_with_routes(model, cfg, toks)
    cpu = copy.deepcopy(model).to("cpu")
    h_cpu, r_cpu = hidden_with_routes(cpu, cfg, toks)
    h_cpu = h_cpu.to(device)
    del cpu
    flips, gaps, same = route_diffs(r_card, r_cpu, FWD_DOCS, PIPE_SEQ)
    if any(g > ROUTE_TIE for g in gaps):
        raise AssertionError(f"{name}: routes differ card vs CPU beyond a near-tie: gaps {gaps}")
    rel = ((h_card - h_cpu).norm(dim=-1) / h_cpu.norm(dim=-1)).cpu()[same]
    if not (rel.numel() and float(rel.max()) <= FWD_FP32_REL):
        raise AssertionError(f"{name}: card fp32 vs CPU over {rel.numel()} tokens, ‖Δ‖/‖h‖ up to "
                             f"{float(rel.max()) if rel.numel() else None}")
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    m16 = lm.cast(model, cfg16)
    del model
    h16, r16 = hidden_with_routes(m16, cfg16, toks)
    del m16
    flips16, gaps16, same16 = route_diffs(r_card, r16, FWD_DOCS, PIPE_SEQ)
    rel16 = ((h16 - h_card).norm(dim=-1) / h_card.norm(dim=-1)).cpu()
    med = float(rel16.median())
    mx = float(rel16[same16].max()) if same16.any() else None
    if not (med <= FWD_BF16_REL_MEDIAN and mx is not None and mx <= FWD_BF16_REL_MAX):
        raise AssertionError(f"{name}: bf16 vs fp32 token ‖Δ‖/‖h‖ median {med}, max {mx} over "
                             f"{int(same16.sum())} tokens")
    torch.cuda.empty_cache()
    keep = same.to(device)
    return {"arch": name, "layers": FWD_LAYERS, "d_model": cfg.d_model, "docs": FWD_DOCS,
            "fp32_card_vs_cpu_rel_max": float(rel.max()), "fp32_tol": FWD_FP32_REL,
            "fp32_card_vs_cpu_abs_max": _max_err(h_card[keep], h_cpu[keep]), "fp32_tokens": int(same.sum()),
            "routes_checked": sum(int(i.numel()) for _, i, _ in r_card), "route_flips_card_vs_cpu": flips,
            "route_flip_gaps": gaps, "bf16_vs_fp32_rel_median": med, "bf16_vs_fp32_rel_max": mx,
            "bf16_max_tokens": int(same16.sum()), "tokens": FWD_DOCS * PIPE_SEQ,
            "bf16_tol": (FWD_BF16_REL_MEDIAN, FWD_BF16_REL_MAX), "route_flips_bf16": flips16,
            "route_flip_gaps_bf16_max": max(gaps16, default=None)}


def k2_check_scaled(x, c, got, want) -> dict:
    """K2 against its plain version by its oracle rule, the chosen
    centroids distance-equivalent with their distances taken from the
    differences, and each row's minimum held to K3's scaled bound
    (``pairwise/ops.py:allowed_error``), as ``kmeans_ties`` holds its copy
    rows: near a zero distance the expansion ‖x‖² + ‖c‖² − 2x·c rounds by
    more than the rule's 1e-4 at these norms. The rows past the rule's
    1e-4 are counted, and there the kernel's minimum must lie within the
    rule's (rtol, atol) of the float64 distance: the rule keeps its
    strength where the plain version is the side that rounds."""
    import torch

    from repro_torch.kernels.kmeans_assign import ops as k2
    from repro_torch.kernels.pairwise.ops import allowed_error

    a_got, a_want = got[0].long(), want[0].long()
    bound = allowed_error(x[:, None, :], c[a_want][:, None, :])[:, 0, 0]
    err = (got[1] - want[1]).abs()
    past = err > k2.TOL[1] + k2.TOL[0] * want[1].abs()
    truth = torch.sum(torch.square(x[past].double() - c[a_want[past]].double()), -1)
    off = (got[1][past].double() - truth).abs()
    row = {"shape": (x.shape[0], c.shape[0], x.shape[1]), "max_abs_err": float(err.max()),
           "bound_min": float(bound.min()), "argmin_equal_frac": float((a_got == a_want).float().mean()),
           "rows_past_spec_tol": int(past.sum()), "past_d2_max": float(want[1][past].max()) if past.any() else None,
           "past_kernel_vs_fp64": float(off.max()) if past.any() else None,
           "past_plain_vs_fp64": float((want[1][past].double() - truth).abs().max()) if past.any() else None}
    direct = [torch.sum(torch.square(x - c[a]), -1) for a in (a_got, a_want)]
    if not (bool(torch.all(err <= bound)) and _close(direct[0], direct[1], *k2.TOL)
            and bool(torch.all(off <= k2.TOL[1] + k2.TOL[0] * truth))):
        raise AssertionError(f"kmeans_assign disagrees with its plain version: {row}")
    return row


def check_path_kernels(device, fit, frozen, x, q, placed, *, random: bool) -> dict:
    """Every kernel of a pipeline path on that path's own data, against its
    plain version by the kernel phase's rules:

    * K1 at the fit's step: ``batch_size`` heads drawn as the fit draws
      them (``sample_step_rows``), their kNN rows and weights, in-cell
      negatives and the cell means, all on the fitted θ;
    * K2 by :func:`k2_check_scaled`: the build's E-step (all rows ``x``
      against the K centroids) and a serving batch of the queries ``q``;
    * K3 by ``allowed_error``: the candidate pass, the in-cell kNN (every
      cell against itself) and serving's query route (each query, one row,
      against its cell);
    * K4 and K5 at a serving batch: the queries' placements ``placed``,
      their cells and k frozen neighbours with the rank weights, the first
      step's in-cell negatives; K4's cotangent is K5's gradient to m.

    With ``random`` also K2 and K3 at the build's shapes on random inputs,
    K2 by its oracle rule as it stands."""
    import torch

    from repro_torch.core.cauchy import cauchy
    from repro_torch.core.nomad import local_means, sample_step_rows
    from repro_torch.core.strategy import LocalStrategy
    from repro_torch.index.build import seeded_generator
    from repro_torch.kernels.cauchy_mean import ops as k4
    from repro_torch.kernels.frozen_attract import ops as k5
    from repro_torch.kernels.kmeans_assign import ops as k2
    from repro_torch.kernels.nomad_step import ops as k1
    from repro_torch.kernels.pairwise import ops as k3
    from repro_torch.serve.transform import assign_and_knn, rank_weight_table, sample_negative_slots

    cfg, c, cells = frozen.cfg, frozen.centroids, frozen.x_blocks
    K, D, C = frozen.n_clusters, frozen.dim, frozen.capacity
    out = {}

    strat = LocalStrategy()
    theta = strat.prepare(cfg, "nomad", fit.index, frozen.theta_rows.cpu().numpy(), device)
    idx = strat.idx
    rows, cl, neg = sample_step_rows(seeded_generator(theta.device, cfg.seed + 1, 0, 0), idx, cfg, "nomad")
    B, S = neg.shape
    p_cell = idx["counts"].float() / float(cfg.n_points)
    args = tuple(t.contiguous() for t in (
        theta[rows], theta[idx["knn_idx"][rows]], idx["knn_w"][rows], theta[neg],
        (cfg.n_noise * p_cell[cl] / S)[:, None].expand(B, S), local_means(theta, idx["counts"], C),
        cfg.n_noise * p_cell, cl.to(torch.int32)))
    shape = (B, args[1].shape[1], S, K, args[0].shape[1])
    out["nomad_step[fit]"] = {"shape": shape, "plan": k1.plan(K), "max_abs_err": _check_pair(
        f"nomad_step on the fit's data at {shape}", nomad_pair(args, torch.full((B,), 1.0 / B, device=device)),
        k1.TOL, K >= 4096)}

    n = min(cfg.serve_microbatch, q.shape[0])
    qb, k, S = q[:n], cfg.n_neighbors, cfg.n_exact_negatives
    own, nb_row, _, nb_valid = assign_and_knn(frozen, qb, k)
    th = torch.from_numpy(np.ascontiguousarray(placed[:n], np.float32)).to(device)
    nb_theta = frozen.theta_rows[nb_row].contiguous()
    nb_w = torch.where(nb_valid, torch.from_numpy(rank_weight_table(k)).to(device)[None, :], 0.0).contiguous()
    p_cell = frozen.counts.float() / float(frozen.n_points)
    cell_w, own32, mu = (cfg.n_noise * p_cell).contiguous(), own.to(torch.int32).contiguous(), frozen.means.contiguous()
    nslot = sample_negative_slots(torch.full((n,), 7, dtype=torch.int64, device=device),
                                  torch.arange(n, device=device), 0, torch.clamp_min(frozen.counts[own], 1), S)
    th_neg = frozen.theta_rows[own[:, None] * C + nslot]
    m = (k4.cauchy_mean_fwd_plain(th, mu, cell_w, own32)
         + (cfg.n_noise * p_cell[own] / S) * torch.sum(cauchy(th[:, None, :], th_neg), -1)).contiguous()
    ones = torch.ones(n, device=device)
    g5, g5_p = k5.frozen_attract_bwd_cuda(th, nb_theta, nb_w, m, ones), k5.frozen_attract_bwd_plain(
        th, nb_theta, nb_w, m, ones)
    outs5 = {"loss": (k5.frozen_attract_fwd_cuda(th, nb_theta, nb_w, m), k5.frozen_attract_fwd_plain(
        th, nb_theta, nb_w, m)), "g_theta": (g5[0], g5_p[0]), "g_m": (g5[1], g5_p[1])}
    gbar = g5_p[1].contiguous()
    outs4 = {"s": (k4.cauchy_mean_fwd_cuda(th, mu, cell_w, own32), k4.cauchy_mean_fwd_plain(th, mu, cell_w, own32)),
             "g_theta": (k4.cauchy_mean_bwd_cuda(th, mu, cell_w, own32, gbar),
                         k4.cauchy_mean_bwd_plain(th, mu, cell_w, own32, gbar))}
    torch.cuda.synchronize()
    out["cauchy_mean[serve batch]"] = {"shape": (n, K, th.shape[1]), "plan": k4.plan(K), "max_abs_err": _check_pair(
        f"cauchy_mean on the served batch at {(n, K)}", outs4, k4.TOL, K >= 4096)}
    out["frozen_attract[serve batch]"] = {"shape": (n, k, th.shape[1]), "max_abs_err": _check_pair(
        f"frozen_attract on the served batch at {(n, k)}", outs5, k5.TOL, False)}

    cell_of = k2.assign_nearest_plain(qb, c)[0].long()
    for label, rows_ in (("kmeans_assign[build]", x), ("kmeans_assign[serve batch]", qb)):
        got, want = k2.assign_nearest_cuda(rows_, c), k2.assign_nearest_plain(rows_, c)
        torch.cuda.synchronize()
        out[label] = k2_check_scaled(rows_, c, got, want)
    pairs = [("pairwise[candidates]", (x, c)), ("pairwise[in-cell]", (cells, cells)),
             ("pairwise[query]", (qb[:256, None, :], cells[cell_of[:256]]))]
    if random:
        g = _gen(device, 3072)
        xr, cr = torch.randn(x.shape, generator=g, device=device), torch.randn(c.shape, generator=g, device=device)
        got, want = k2.assign_nearest_cuda(xr, cr), k2.assign_nearest_plain(xr, cr)
        torch.cuda.synchronize()
        k2.oracle_check(xr, cr, got, want)  # raises on disagreement
        out["kmeans_assign[random]"] = {"shape": (xr.shape[0], K, D), "max_abs_err": _max_err(got[1], want[1]),
                                        "argmin_equal_frac": float((got[0] == want[0]).float().mean())}
        pairs.append(("pairwise[random]", (xr, cr)))
    for label, (a, b) in pairs:
        got, want = k3.pairwise_dist2_cuda(a, b), k3.pairwise_dist2_plain(a, b)
        torch.cuda.synchronize()
        bound = k3.allowed_error(a, b)
        if not bool(torch.all((got - want).abs() <= bound)):
            raise AssertionError(f"{label} disagrees with its plain version at D {D}: {_max_err(got, want)}")
        out[label] = {"shape": tuple(a.shape[:-1]) + (b.shape[-2], D), "route": k3.route(
            a.shape[0] if a.dim() == 3 else 1, a.shape[-2], b.shape[-2], D),
            "max_abs_err": _max_err(got, want), "bound_min": float(bound.min())}
    return out


def knn_class_agreement(v: np.ndarray, classes: np.ndarray, device) -> float:
    """Share of each row's ``PIPE_AGREEMENT_K`` nearest rows (itself left
    out, exact, on the card) that hold its class."""
    from repro_torch.metrics.neighborhood import exact_knn

    nn = exact_knn(v, np.arange(v.shape[0]), PIPE_AGREEMENT_K, device=device)
    return float((classes[nn] == classes[:, None]).mean())


def pipeline_path(device) -> dict:
    """The embed → map → serve → explore pipeline on the card, the steps
    the module docstring lists under phase 8. Launch counts are read
    around the map and its serving (the fit of the embedded corpus, the
    held-out placements and explore)."""
    import shutil

    import torch

    from repro_torch.configs import PIPELINE_WORKLOADS
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.embeddings import embed_corpus
    from repro_torch.data.synthetic import class_token_corpus
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.pipeline import (embed_to_store, inverse_from_frozen, make_embed_fn, roundtrip_score,
                                      run_pipeline, save_inverse)
    from repro_torch.serve import FrozenMap, MapServer
    from repro_torch.service import MapService

    work = os.path.join(OUT_DIR, "pipeline")
    shutil.rmtree(work, ignore_errors=True)
    out = {"reduced": PIPELINE_REDUCED}
    try:
        # 4. the forward against the CPU, and bf16 against fp32 (first: the
        # embed's peak memory below is then its own)
        out["forward_checks"] = []
        for name in FWD_ARCHS:
            t0 = time.time()
            row = forward_check(device, name)
            row["check_s"] = time.time() - t0
            out["forward_checks"].append(row)
            print(json.dumps({"pipeline_forward_check": row}), flush=True)

        # 1. the embedder at its published widths
        acfg = pipeline_arch()
        torch.cuda.synchronize(device)
        t0 = time.time()
        model = lm.init_params(acfg, generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize(device)
        n_params = lm.n_params(model)
        out["embedder"] = {"arch": acfg.name, "n_layers": acfg.n_layers, "d_model": acfg.d_model,
                           "vocab": acfg.vocab_size, "dtype": acfg.param_dtype, "init_s": time.time() - t0,
                           "params": n_params, "param_counts": acfg.param_counts(),
                           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
        if n_params != acfg.param_counts()["total"]:
            raise AssertionError(f"{n_params} parameters, param_counts() says {acfg.param_counts()}")
        print(json.dumps({"pipeline_embedder": out["embedder"]}), flush=True)

        # 2. the corpus, embedded into a store
        tokens, classes = class_token_corpus(PIPE_DOCS, PIPE_SEQ, acfg.vocab_size, n_classes=PIPE_CLASSES, seed=0)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held_gb = torch.cuda.memory_allocated(device) / 1e9  # the weights, and what earlier phases left
        t0 = time.perf_counter()
        store = embed_to_store(model, acfg, tokens, os.path.join(work, "embeddings"), pool="mean",
                               doc_batch=PIPE_DOC_BATCH)
        wall = time.perf_counter() - t0
        flops = dense_matmul_flops(acfg, PIPE_SEQ) * tokens.size
        fwd = make_embed_fn(acfg, "mean")
        b_wall, b_busy = device_busy(device, lambda: fwd(model, tokens[:PIPE_DOC_BATCH]).cpu())
        out["embed"] = {"docs": PIPE_DOCS, "seq_len": PIPE_SEQ, "doc_batch": PIPE_DOC_BATCH, "tokens": int(tokens.size),
                        "wall_s": wall, "tokens_per_s": tokens.size / wall, "matmul_flops": flops,
                        "tflops_per_s": flops / wall / 1e12, "peak_share_bf16": flops / wall / PEAK_BF16_FLOPS,
                        "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9, "held_before_gb": held_gb,
                        "batch_wall_s": b_wall, "batch_device_s": b_busy, "batch_busy_share": b_busy / b_wall,
                        "store_shape": store.shape, "store_dtype": store.dtype_name}
        print(json.dumps({"pipeline_embed": out["embed"]}, default=str), flush=True)
        x = store.materialize()
        if x.shape != (PIPE_DOCS, acfg.d_model) or not np.isfinite(x).all():
            raise AssertionError(f"the store holds {x.shape}, finite {np.isfinite(x).all()}")

        # 3. streamed ≡ materialized, and a second embed, bit for bit
        first = tokens[:PIPE_EQUIV_DOCS]
        store2 = embed_to_store(model, acfg, first, os.path.join(work, "embeddings2"), doc_batch=PIPE_DOC_BATCH)
        mat = embed_corpus(model, acfg, [first[i : i + PIPE_DOC_BATCH] for i in range(0, len(first), PIPE_DOC_BATCH)])
        if not (np.array_equal(store2.materialize(), mat) and np.array_equal(x[:PIPE_EQUIV_DOCS], mat)):
            raise AssertionError("the stores' rows differ from embed_corpus's matrix")
        wl = PIPELINE_WORKLOADS[PIPE_WORKLOAD]
        ecfg = wl.nomad_config(PIPE_EQUIV_DOCS, acfg.d_model, chunk_rows=PIPE_EQUIV_CHUNK, seed=0)
        e_store = NomadProjection(ecfg, device=device).fit(store2).embedding
        e_mat = NomadProjection(ecfg, device=device).fit(mat).embedding
        if not np.array_equal(e_store, e_mat):
            raise AssertionError("fit(embed_to_store) differs from fit(embed_corpus)")
        out["streamed_equal_materialized"] = {"docs": PIPE_EQUIV_DOCS, "chunk_rows": PIPE_EQUIV_CHUNK,
                                              "store_equal_matrix": True, "rerun_equal": True, "fit_equal": True}
        shutil.rmtree(os.path.join(work, "embeddings2"))

        # 5. map the corpus: fit, inverse, round trip, as run_pipeline strings them
        ckdir = os.path.join(work, "map")
        cfg = wl.nomad_config(PIPE_DOCS, acfg.d_model, checkpoint_dir=ckdir, seed=0, **PIPE_FIT)
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        fit = NomadProjection(cfg, device=device).fit(store)
        stage_s = {"embed": wall, "fit": time.perf_counter() - t0}
        frozen = FrozenMap.from_fit(fit, cfg, device=device)
        t0 = time.perf_counter()
        head = inverse_from_frozen(frozen, hidden=(64, 64), steps=600, seed=0)
        torch.cuda.synchronize(device)
        stage_s["inverse_train"] = time.perf_counter() - t0
        save_inverse(ckdir, head)
        r2 = roundtrip_score(head, fit.embedding, x, device=device)
        agree_map = knn_class_agreement(fit.embedding, classes, device)
        agree_vec = knn_class_agreement(x, classes, device)
        out["map"] = {"config": {k: getattr(cfg, k) for k in ("n_points", "dim", "n_clusters", "n_neighbors",
                                                             "n_epochs", "batch_size", "chunk_rows")},
                      "stage_s": stage_s, "fit_stage_s": fit.stage_s, "roundtrip_r2": r2,
                      "knn10_class_agreement_map": agree_map, "knn10_class_agreement_pooled": agree_vec,
                      "agreement_min": PIPE_AGREEMENT_MIN, "capacity": cfg.cluster_capacity}
        print(json.dumps({"pipeline_map": out["map"]}, default=str), flush=True)
        if not agree_map > PIPE_AGREEMENT_MIN:
            raise AssertionError(f"the map's 10-NN class agreement {agree_map} is not above {PIPE_AGREEMENT_MIN} "
                                 f"(pooled vectors: {agree_vec})")

        # 6. serve the pipeline's directory alone
        held, _ = class_token_corpus(PIPE_HELD_OUT, PIPE_SEQ, acfg.vocab_size, n_classes=PIPE_CLASSES, seed=1)
        q = embed_corpus(model, acfg, [held[i : i + PIPE_DOC_BATCH] for i in range(0, PIPE_HELD_OUT, PIPE_DOC_BATCH)])
        svc = MapService(device=device)
        try:
            handle = svc.registry.load(ckdir)
            per_batch = serve_launches_per_batch(cfg)
            before = registry.launch_counts()
            placed = svc.project(q, seed=7)
            after = registry.launch_counts()
            got = {n: after[n] - before[n] for n in after}
            coords = fit.embedding[:EXPLORE_ROWS]
            ex = svc.explore(coords)
            walls = [svc.explore(coords).wall_s for _ in range(10)]
            out["launches"] = registry.launch_counts()  # the comparisons below launch too: not counted
            if got != per_batch:
                raise AssertionError(f"held-out placement launched {got}, want one batch's {per_batch}")
            if not _same_result(placed.result, MapServer(handle.frozen).transform(q, seed=7)):
                raise AssertionError("MapService.project differs from a direct MapServer.transform")
            dec = handle.inverse.decode(coords, device=device)
            ids, dists = handle.frozen.neighbors(dec)
            if not (np.array_equal(ex.embedding, dec) and np.array_equal(ex.neighbor_ids, ids)
                    and np.array_equal(ex.neighbor_dists, dists)):
                raise AssertionError("explore differs from FrozenMap.neighbors(decode(coords))")
            out["serve"] = {"held_out": PIPE_HELD_OUT, "launches_one_batch": got, "equal_direct": True,
                            "explore_rows": EXPLORE_ROWS, "explore_equal_neighbors_of_decode": True,
                            "explore_p50_s": float(np.percentile(walls, 50)), "explore_walls_s": walls,
                            "project_wall_s": placed.wall_s}
            out["kernels_d3072"] = check_path_kernels(
                device, fit, handle.frozen, torch.from_numpy(x).to(device), torch.from_numpy(q).to(device),
                placed.result.embedding, random=True)
        finally:
            svc.close()
        print(json.dumps({"pipeline_serve": out["serve"], "launches": out["launches"]}), flush=True)
        print(json.dumps({"pipeline_kernels_d3072": out["kernels_d3072"]}), flush=True)
        del model, frozen, fit, head
        torch.cuda.empty_cache()

        # 7. run_pipeline for every registered workload, at its own widths
        out["run_pipeline"] = {}
        for name, w in sorted(PIPELINE_WORKLOADS.items()):
            t0 = time.time()
            r = run_pipeline(w, os.path.join(work, name), device=device)
            files = sorted(os.listdir(r.checkpoint_dir))
            if not {"index.npz", "inverse.npz"} <= set(files) or r.store.shape != (w.n_docs, w.d_model):
                raise AssertionError(f"{name}: artifacts {files}, store {r.store.shape}")
            s = MapService(device=device)
            try:
                s.registry.load(r.checkpoint_dir)
                ex = s.explore(r.fit.embedding[:8], k=5)
                ids, _ = r.frozen.neighbors(ex.embedding, k=5)
                if not np.array_equal(ids, ex.neighbor_ids):
                    raise AssertionError(f"{name}: explore from map/ differs from the fit's frozen map")
            finally:
                s.close()
            xs = r.store.materialize()
            xd = torch.from_numpy(xs).to(device)
            kernels = check_path_kernels(device, r.fit, r.frozen, xd, xd,
                                         MapServer(r.frozen).transform(xs, seed=7).embedding, random=False)
            out["run_pipeline"][name] = {"stage_s": r.stage_s, "roundtrip_r2": r.roundtrip_score,
                                         "store_shape": r.store.shape, "wall_s": time.time() - t0,
                                         "kernels": kernels}
        print(json.dumps({"pipeline_run_pipeline": out["run_pipeline"]}, default=str), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: the LM's serving path (prefill into the KV/SSM cache, decode)
# ---------------------------------------------------------------------------

DECODE_BATCH = 16
DECODE_PROMPT = 2_048  # Phi-4-mini: two attention chunks of 1024; Mamba-2: eight SSD chunks of 256
DECODE_NEW = 256  # greedy decode steps after the prefill's own next token
DECODE_MAMBA = "mamba2-2.7b"
# fp32 decode against the full forward, and the card's step against the
# CPU's, ‖Δ logits‖/‖logits‖ a sequence: both sum in float32 over D =
# 2560-14336 terms in other orders, through two layers (as FWD_FP32_REL)
DECODE_FP32_REL = 1e-4
# (batch, prompt, decode steps) of the fp32 parity checks at 2 layers. Phi-4-mini:
# prompt and forward within attn_chunk (the full path). Mamba-2: two SSD
# chunks. Mixtral: a prompt past its 4,096 window (the ring branch of
# load_cache_from_prefill: slots 0-4093 hold positions 4096-8189), then the
# decode at positions 8190-8195 writes slots 4094, 4095, 0, 1, 2, 3: a further wrap
DECODE_PARITY = {"phi4-mini-3.8b": (4, 1_016, 8), "mamba2-2.7b": (4, 512, 8), "mixtral-8x7b": (1, 8_190, 6)}
DECODE_BF16 = (4, 1_024)  # batch, forward length: prefill all but the last token, one decode step
# the bf16 decode's distance to the fp32 forward against the bf16
# forward's own, ‖Δ‖/‖logits‖ a sequence: both round the same activations
# to 8 bits at the same points, so the decode may lose a quarter more than
# the forward, no more. The forward checks' bounds (FWD_BF16_REL_*) on
# the bf16 decode against the bf16 forward hold Phi-4-mini's 32 layers;
# Mamba-2's bf16 forward alone lies ~0.05 from its fp32 forward after 64
# layers, so its two bf16 paths part by about as much: only this bound
# applies there
DECODE_BF16_EXCESS = 1.25
DECODE_CORPUS = (512, 256)  # documents, tokens: the map lookup's corpus (examples/serve_lm.py --map-lookup)
DECODE_WINDOW = 1_024  # tokens of prompt + continuation embedded for the lookup (the full path)
DECODE_MAP = dict(n_clusters=8, n_epochs=4, batch_size=512, chunk_rows=1024)  # the example's NomadConfig
DECODE_REDUCED = [
    f"decode_32k: global_batch 128 -> {DECODE_BATCH} and seq_len 32,768 -> {DECODE_PROMPT + DECODE_NEW:,} "
    f"(a {DECODE_PROMPT:,}-token prompt and {DECODE_NEW} steps): one card's memory under the plain decode "
    "attention, and the script's time limit",
    "weights: random from a seeded torch.Generator (bf16), not the published checkpoints",
    "head_pad_to 16 -> 1, vocab_pad_to 256 -> 1 (one card, no tensor axis; a layout, not a cut)",
    "fp32 parity: 2 of the published layers; Mixtral's capacity_factor 1.25 -> 4.0 = E/top_k (drop-free, "
    "so decode and the forward route alike); attn_chunk and ssm_chunk cut, where a sequence exceeds them, to "
    "the largest divisor of its length (Mixtral: 910 for the 8,190-token prefill, 683 for the 8,196-token "
    "forward; Mamba-2: 130 for the 520-token forward), as both packages need whole chunks",
    f"map lookup: the corpus is {DECODE_CORPUS[0]} documents x {DECODE_CORPUS[1]} tokens of the prompts' "
    f"class_token_corpus, and a continuation is embedded with the last {DECODE_WINDOW - DECODE_NEW - 1} prompt "
    f"tokens ({DECODE_WINDOW} in all: 2,305 tokens are not a whole number of attention chunks)",
]


def chunked(cfg, n: int):
    """``cfg`` with ``attn_chunk`` and ``ssm_chunk`` cut, where ``n`` tokens
    exceed them, to the largest divisor of ``n`` not above them: both
    packages need a sequence longer than a chunk to be whole chunks."""
    import dataclasses

    def cut(c: int) -> int:
        return c if n <= c else max(d for d in range(1, c + 1) if n % d == 0)

    return dataclasses.replace(cfg, attn_chunk=cut(cfg.attn_chunk), ssm_chunk=cut(cfg.ssm_chunk))


def ssm_matmul_flops(cfg, seq: int) -> float:
    """A Mamba-2 model's matmul FLOPs a token of a ``seq``-token prefill in
    SSD chunks of Q = min(ssm_chunk, seq): the z/x/B/C/Δ and output
    projections, the chunk's C·B scores and their product with x, the
    carried state's read (C·h) and the chunk state's update (x ⊗ B), 2 a
    multiply-add; the convs, norms and gates are none."""
    D, di, N, H, P = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, seq)
    return float(cfg.n_layers * 2 * (D * (2 * di + 2 * N + H) + di * D + Q * N + Q * H * P + 2 * H * P * N))


def last_logits(model, cfg, tokens, first: int):
    """The full forward's logits at positions ``first`` … (B, n − first, V)
    fp32: the hidden states of the whole sequence, then only those rows
    through the final norm and the vocabulary product."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.layers import rms_norm

    with torch.inference_mode():
        x, _, _ = lm.body(model, cfg, lm.embed_in(model, cfg, tokens=tokens))
        return lm.logits_out(model, cfg, rms_norm(x[:, first:], model.final_ln))


def seq_rel(got, want):
    """‖Δ‖/‖want‖ over the vocabulary, a sequence (and a step), on the host."""
    return ((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)).cpu()


def decode_parity(device, name: str) -> dict:
    """``name`` at its published widths with 2 layers, fp32 (TF32 off):
    prefill, then decode steps against the full forward over the same
    tokens (``DECODE_FP32_REL`` a sequence, every step), and the last step
    on the card against the port's CPU step from the same cache and
    weights."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm, steps

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the card's fp32 decode would not be fp32")
    B, P, n_steps = DECODE_PARITY[name]
    base = ARCHS[name]
    cfg = dataclasses.replace(base, n_layers=FWD_LAYERS, head_pad_to=1, vocab_pad_to=1, param_dtype="float32",
                              compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, P + n_steps)).astype(np.int32)
    model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(1))
    pre_cfg, full_cfg = chunked(cfg, P), chunked(cfg, P + n_steps)
    t0 = time.time()
    _, stacked = steps.make_prefill_step(pre_cfg)(model, {"tokens": toks[:, :P]})
    cache = lm.load_cache_from_prefill(cfg, lm.init_cache(cfg, B, P + n_steps, filled=P, device=device), stacked, P)
    del stacked
    ring = "k" in cache and cache["k"].shape[2] < P
    decode, got = steps.make_decode_step(cfg), []
    for t in range(P, P + n_steps):
        if t == P + n_steps - 1:
            before = {k: (v.cpu().clone() if k != "idx" else v) for k, v in cache.items()}
        logits, cache = decode(model, cache, toks[:, t : t + 1])
        got.append(logits[:, 0])
    slots = [t % cache["k"].shape[2] for t in range(P, P + n_steps)] if "k" in cache else None
    want = last_logits(model, full_cfg, toks, P)
    rel = seq_rel(torch.stack(got, 1), want)  # (B, steps)
    torch.cuda.synchronize(device)
    card_s = time.time() - t0
    cpu = copy.deepcopy(model).to("cpu")
    cpu_logits, _ = lm.decode_step(cpu, cfg, before, toks[:, P + n_steps - 1 : P + n_steps])
    del cpu, before
    rel_cpu = seq_rel(got[-1].cpu(), cpu_logits[:, 0])
    out = {"arch": name, "layers": FWD_LAYERS, "d_model": cfg.d_model, "batch": B, "prompt": P,
           "decode_steps": n_steps, "attn_chunk": [pre_cfg.attn_chunk, full_cfg.attn_chunk],
           "ssm_chunk": [pre_cfg.ssm_chunk, full_cfg.ssm_chunk], "capacity_factor": cfg.capacity_factor,
           "cache_slots": None if "k" not in cache else int(cache["k"].shape[2]), "ring_at_prefill": ring,
           "decode_slots": slots, "rel_vs_forward_max": float(rel.max()), "rel_vs_forward_last": float(rel[:, -1].max()),
           "rel_card_vs_cpu": float(rel_cpu.max()), "tol": DECODE_FP32_REL,
           "argmax_equal_forward": float((torch.stack(got, 1).argmax(-1) == want.argmax(-1)).float().mean()),
           "card_s": card_s}
    del model, cache, got, want
    torch.cuda.empty_cache()
    if not (rel.max() <= DECODE_FP32_REL and rel_cpu.max() <= DECODE_FP32_REL):
        raise AssertionError(f"{name}: fp32 decode vs forward {float(rel.max())}, card vs CPU "
                             f"{float(rel_cpu.max())} (tol {DECODE_FP32_REL})")
    if name == "mixtral-8x7b" and not (ring and 0 in slots and slots[0] > slots[-1]):
        raise AssertionError(f"mixtral's check did not wrap the ring: prefill ring {ring}, slots {slots}")
    return out


def greedy(device, model, cfg, prompts, new: int, busy_step=None):
    """Prefill ``prompts`` (B, P), then ``new`` greedy decode steps on the
    card: (tokens (B, new + 1) on the host, the last logits, prefill wall
    s, decode wall s, each step's CUDA-event ms, the profiled step's
    (wall s, device s) or None). The argmax stays on the card; the
    profiled step (``busy_step``) is left out of the step times."""
    import torch

    from repro_torch.models import lm, steps

    B, P = prompts.shape
    decode = steps.make_decode_step(cfg)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, stacked = steps.make_prefill_step(cfg)(model, {"tokens": prompts})
    cache = lm.load_cache_from_prefill(cfg, lm.init_cache(cfg, B, P + new, filled=P, device=device), stacked, P)
    del stacked
    torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out, events, busy = [tok], [], None
    t0 = time.perf_counter()
    for i in range(new):
        if i == busy_step:
            holder = {}

            def one():
                holder["r"] = decode(model, cache, tok)

            busy = device_breakdown(device, one, top=12)
            logits, cache = holder["r"]
        else:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            logits, cache = decode(model, cache, tok)
            e1.record()
            events.append((e0, e1))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize(device)
    decode_s = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    if cache["idx"] != P + new:
        raise AssertionError(f"the cache's idx is {cache['idx']} after {new} steps from {P}")
    return torch.cat(out, 1).cpu().numpy(), logits, prefill_s, decode_s, ms, busy


def serve_lm(device, model, cfg, prompts, flops_per_token: float, state_bytes: float):
    """The slice at full depth: prefill ``prompts``, ``DECODE_NEW`` greedy
    steps, timed; a rerun from the same weights must give the same
    continuations and last logits bit for bit. ``state_bytes`` is what a
    step reads of the cache (and an SSM writes back). Returns (the
    numbers, the continuations (B, DECODE_NEW + 1) on the host)."""
    import torch

    B, P = prompts.shape
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    toks, last, prefill_s, decode_s, ms, busy = greedy(device, model, cfg, prompts, DECODE_NEW,
                                                      busy_step=DECODE_NEW // 2)
    peak = torch.cuda.max_memory_allocated(device)
    toks2, last2, prefill2_s, decode2_s, ms2, _ = greedy(device, model, cfg, prompts, DECODE_NEW)
    if not (np.array_equal(toks, toks2) and torch.equal(last, last2)):
        raise AssertionError(f"{cfg.name}: a rerun decodes other tokens "
                             f"({int((toks != toks2).sum())} of {toks.size} differ)")
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = (param_bytes + state_bytes) / PEAK_BYTES_PER_S * 1e3
    flops = flops_per_token * B * P
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    if not np.isfinite(last.float().cpu().numpy()).all():
        raise AssertionError(f"{cfg.name}: non-finite logits after {DECODE_NEW} steps")
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.param_dtype,
            "params": sum(p.numel() for p in model.parameters()), "param_bytes": param_bytes,
            "batch": B, "prompt": P, "new_tokens": DECODE_NEW, "cache_capacity": P + DECODE_NEW,
            "prefill_s": prefill_s, "prefill_tokens_per_s": B * P / prefill_s, "prefill_matmul_flops": flops,
            "prefill_tflops_per_s": flops / prefill_s / 1e12, "prefill_peak_share_bf16": flops / prefill_s / PEAK_BF16_FLOPS,
            "decode_s": decode_s, "decode_tokens_per_s": B * DECODE_NEW / decode_s,
            "step_ms_p50": p50, "step_ms_p99": p99, "step_ms_mean": float(np.mean(ms)),
            "rerun_step_ms_p50": float(np.percentile(ms2, 50)), "rerun_prefill_s": prefill2_s,
            "step_wall_s_profiled": busy[0], "step_device_s_profiled": busy[1], "step_busy_share": busy[1] / busy[0],
            "step_top_kernels": busy[2],
            "step_bytes": param_bytes + state_bytes, "step_bound_ms": bound_ms, "step_p50_over_bound": p50 / bound_ms,
            "peak_device_gb": peak / 1e9, "held_before_gb": held / 1e9, "rerun_bit_equal": True,
            "continuation_head": toks[:2, :8].tolist()}, toks


def decode_vs_forward(device, model, cfg, seed: int, *, bf16_bounds: bool) -> dict:
    """Full depth: one decode step after a prefill of all but the last of
    ``DECODE_BF16[1]`` tokens, against the full forward's last position,
    ‖Δ‖/‖logits‖ a sequence, in the model's bf16 and in fp32 on the same
    weights widened (``lm.cast``). Held: the fp32 decode to the fp32
    forward within ``DECODE_FP32_REL``; the bf16 decode no further from
    the fp32 forward than ``DECODE_BF16_EXCESS`` times the bf16 forward
    is (median and max; max ≤ ``FWD_BF16_REL_MAX``); with ``bf16_bounds``
    also the bf16 decode to the bf16 forward within ``FWD_BF16_REL_*``.
    Argmax agreement reported."""
    import dataclasses

    import torch

    from repro_torch.models import lm, steps

    B, n = DECODE_BF16
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)

    def step_and_forward(m, c):
        _, stacked = steps.make_prefill_step(chunked(c, n - 1))(m, {"tokens": toks[:, :-1]})
        cache = lm.load_cache_from_prefill(c, lm.init_cache(c, B, n, filled=n - 1, device=device), stacked, n - 1)
        del stacked
        logits, _ = lm.decode_step(m, c, cache, toks[:, -1:])
        return logits[:, 0], last_logits(m, chunked(c, n), toks, n - 1)[:, 0]

    d16, f16 = step_and_forward(model, cfg)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    m32 = lm.cast(model, cfg32)
    d32, f32 = step_and_forward(m32, cfg32)
    del m32
    torch.cuda.empty_cache()
    rel, rel32 = seq_rel(d16, f16), seq_rel(d32, f32)
    rel_d16, rel_f16 = seq_rel(d16, f32), seq_rel(f16, f32)
    med, mx = float(rel.median()), float(rel.max())
    out = {"batch": B, "prompt": n - 1, "forward": n, "chunks": [chunked(cfg, n - 1).ssm_chunk, chunked(cfg, n).ssm_chunk],
           "rel_median": med, "rel_max": mx, "tol": (FWD_BF16_REL_MEDIAN, FWD_BF16_REL_MAX), "bf16_bounds": bf16_bounds,
           "fp32_decode_vs_forward_max": float(rel32.max()), "fp32_tol": DECODE_FP32_REL,
           "bf16_decode_vs_fp32_forward": [float(rel_d16.median()), float(rel_d16.max())],
           "bf16_forward_vs_fp32_forward": [float(rel_f16.median()), float(rel_f16.max())],
           "excess_tol": DECODE_BF16_EXCESS,
           "argmax_agreement": float((d16.argmax(-1) == f16.argmax(-1)).float().mean()),
           "argmax_agreement_fp32": float((d32.argmax(-1) == f32.argmax(-1)).float().mean())}
    if not rel32.max() <= DECODE_FP32_REL:
        raise AssertionError(f"{cfg.name}: fp32 decode vs forward at full depth {float(rel32.max())}")
    if not (rel_d16.median() <= DECODE_BF16_EXCESS * rel_f16.median()
            and rel_d16.max() <= min(DECODE_BF16_EXCESS * rel_f16.max(), FWD_BF16_REL_MAX)):
        raise AssertionError(f"{cfg.name}: bf16 decode vs the fp32 forward {out['bf16_decode_vs_fp32_forward']}, "
                             f"the bf16 forward's {out['bf16_forward_vs_fp32_forward']}")
    if bf16_bounds and not (med <= FWD_BF16_REL_MEDIAN and mx <= FWD_BF16_REL_MAX):
        raise AssertionError(f"{cfg.name}: bf16 decode vs forward median {med}, max {mx}")
    return out


def map_lookup(device, model, cfg, docs, doc_classes, prompts, prompt_classes, continuations, work) -> dict:
    """``examples/serve_lm.py --map-lookup`` on the card: the corpus
    embedded into a store by the same model, a small map fitted on it and
    frozen, then each prompt's tail + continuation embedded and looked up
    (``FrozenMap.neighbors(·, k=3)``). Launch counts: the fit (K1-K3) and
    the lookup, which must be one batch's K2 and K3; then every kernel
    against its plain version on this map's data (``check_path_kernels``,
    K4/K5 at the continuations' placements)."""
    import torch

    from repro_torch.configs import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.kernels import registry
    from repro_torch.pipeline import embed_to_store, make_embed_fn
    from repro_torch.serve import FrozenMap, MapServer

    t0 = time.perf_counter()
    store = embed_to_store(model, cfg, docs, os.path.join(work, "corpus"), doc_batch=64)
    embed_s = time.perf_counter() - t0
    ncfg = NomadConfig(n_points=store.shape[0], dim=store.shape[1], **DECODE_MAP)
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    fit = NomadProjection(ncfg, device=device).fit(store)
    fit_s = time.perf_counter() - t0
    fz = FrozenMap.from_fit(fit, ncfg, device=device)
    fit_launches = registry.launch_counts()
    if not all(fit_launches[n] for n in FIT_KERNELS):
        raise AssertionError(f"the lookup's map fit launched {fit_launches}")
    window = np.concatenate([prompts[:, -(DECODE_WINDOW - continuations.shape[1]) :], continuations], axis=1)
    vecs = make_embed_fn(cfg)(model, window.astype(np.int32)).cpu().numpy()
    before = registry.launch_counts()
    t0 = time.perf_counter()
    ids, dists = fz.neighbors(vecs, k=3)
    lookup_s = time.perf_counter() - t0
    after = registry.launch_counts()
    lookup = {n: after[n] - before[n] for n in after}
    want = {n: 0 for n in after}
    want.update(kmeans_assign=1, pairwise=-(-len(vecs) // ncfg.serve_knn_block))
    if lookup != want:
        raise AssertionError(f"the lookup launched {lookup}, want one batch's {want}")
    if not (ids.shape == (len(vecs), 3) and (ids >= 0).all() and np.isfinite(dists).all()):
        raise AssertionError(f"lookup ids {ids.tolist()}, distances {dists.tolist()}")
    same_class = float((doc_classes[ids] == prompt_classes[:, None]).mean())
    placed = MapServer(fz).transform(vecs, seed=7).embedding
    kernels = check_path_kernels(device, fit, fz, torch.from_numpy(store.materialize()).to(device),
                                 torch.from_numpy(vecs).to(device), placed, random=False)
    return {"docs": docs.shape, "embed_s": embed_s, "fit_s": fit_s, "map": DECODE_MAP, "window": window.shape,
            "fit_launches": fit_launches, "lookup_launches": lookup, "lookup_s": lookup_s,
            "ids_head": ids[:4].tolist(), "dists_head": dists[:4].tolist(), "neighbour_same_class": same_class,
            "kernels": kernels, "launches": after}


def mamba_arch():
    """Mamba-2 2.7B at its published widths, the vocabulary unpadded."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[DECODE_MAMBA], head_pad_to=1, vocab_pad_to=1)
    want = dict(n_layers=64, d_model=2560, ssm_state=128, ssm_head_dim=64, vocab_size=50_280,
                param_dtype="bfloat16", compute_dtype="bfloat16", ssm_chunk=256)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"{DECODE_MAMBA} is not at its published widths: {got}")
    return cfg


def decode_path(device) -> dict:
    """The LM's serving path on the card: fp32 parity at 2 layers
    (Phi-4-mini, Mamba-2, Mixtral with its ring), then Phi-4-mini and
    Mamba-2 at full depth in bf16 serving ``DECODE_BATCH`` prompts of
    ``DECODE_PROMPT`` tokens for ``DECODE_NEW`` greedy steps, a bf16 decode
    against the full forward, and the map lookup of the continuations.
    Launch counts are read around the lookup's map fit and the lookup."""
    import shutil

    import torch

    from repro_torch.data.synthetic import class_token_corpus
    from repro_torch.models import lm

    work = os.path.join(OUT_DIR, "decode")
    shutil.rmtree(work, ignore_errors=True)
    out = {"reduced": DECODE_REDUCED, "parity": []}
    try:
        for name in DECODE_PARITY:
            row = decode_parity(device, name)
            out["parity"].append(row)
            print(json.dumps({"decode_parity": row}), flush=True)

        # Phi-4-mini at full depth: the pipeline phase's weights, drawn from its seed
        acfg = pipeline_arch()
        model = lm.init_params(acfg, generator=torch.Generator(device=device).manual_seed(0))
        n_docs, doc_len = DECODE_CORPUS
        corpus, classes = class_token_corpus(DECODE_BATCH + n_docs, DECODE_PROMPT, acfg.vocab_size,
                                             n_classes=PIPE_CLASSES, seed=3)
        prompts = corpus[:DECODE_BATCH]
        kv_bytes = 2 * acfg.n_layers * DECODE_BATCH * (DECODE_PROMPT + DECODE_NEW // 2) * acfg.n_kv_heads * \
            acfg.head_dim * 2  # k and v, bf16, the valid positions at the median step
        phi, continuations = serve_lm(device, model, acfg, prompts, dense_matmul_flops(acfg, DECODE_PROMPT), kv_bytes)
        print(json.dumps({"decode_serve": phi}), flush=True)
        phi["bf16_vs_forward"] = decode_vs_forward(device, model, acfg, seed=5, bf16_bounds=True)
        print(json.dumps({"decode_bf16_vs_forward": phi["bf16_vs_forward"]}), flush=True)
        lookup = map_lookup(device, model, acfg, corpus[DECODE_BATCH:, -doc_len:], classes[DECODE_BATCH:], prompts,
                            classes[:DECODE_BATCH], continuations, work)
        out["launches"] = lookup.pop("launches")
        out["map_lookup"] = lookup
        print(json.dumps({"decode_map_lookup": lookup}, default=str), flush=True)
        out["phi4_mini"] = phi
        del model
        torch.cuda.empty_cache()

        # Mamba-2 at full depth
        mcfg = mamba_arch()
        model = lm.init_params(mcfg, generator=torch.Generator(device=device).manual_seed(0))
        m_prompts, _ = class_token_corpus(DECODE_BATCH, DECODE_PROMPT, mcfg.vocab_size, n_classes=PIPE_CLASSES, seed=3)
        state_bytes = 2 * mcfg.n_layers * DECODE_BATCH * 4 * (  # read and written, float32
            mcfg.ssm_heads * mcfg.ssm_head_dim * mcfg.ssm_state + (mcfg.ssm_conv - 1) * (mcfg.d_inner + 2 * mcfg.ssm_state))
        mamba, _ = serve_lm(device, model, mcfg, m_prompts, ssm_matmul_flops(mcfg, DECODE_PROMPT), state_bytes)
        print(json.dumps({"decode_serve": mamba}), flush=True)
        mamba["bf16_vs_forward"] = decode_vs_forward(device, model, mcfg, seed=6, bf16_bounds=False)
        print(json.dumps({"decode_bf16_vs_forward": mamba["bf16_vs_forward"]}), flush=True)
        out["mamba2"] = mamba
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 10: the LM's training path
# ---------------------------------------------------------------------------

# attend_flash against autograd through attend_full, float32 (TF32 off):
# name -> (heads, kv heads, head_dim, batch, seq, chunk, window)
TRAIN_FLASH = {"phi4-mini heads": (24, 8, 128, 1, 4_096, 1_024, 0),
               "mixtral window": (32, 8, 128, 1, 8_192, 1_024, 4_096)}
# each of out, dq, dk, dv, ‖Δ‖/‖ref‖: both sum float32 products in other
# orders over ≤ 8,192 keys (~1e-7 each, measured on the CPU ≤ 3e-7)
FLASH_REL = 1e-5
TRAIN_PARITY_ARCHS = ("phi4-mini-3.8b", "mamba2-2.7b", "mixtral-8x7b")
TRAIN_PARITY_BATCH = (2, 256)  # TokenStream rows x tokens of the card-vs-CPU step
TRAIN_PARITY_LR = 0.1  # the SGD step's learning rate
TRAIN_LOSS_REL = 1e-5  # card vs CPU, the fp32 step's loss
TRAIN_ACCUM, TRAIN_MICRO, TRAIN_SEQ = 4, 2, 4_096  # Phi-4-mini's train_4k, global batch 256 -> 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 6  # untimed then timed Phi-4-mini steps
TRAIN_MAMBA_STEPS = 3
# Mamba-2's train step is host-bound (on an NVIDIA H100 80GB HBM3, 700 W:
# ~42-64 s at its 64 layers, the card ~25-34% busy: the SSD scan's chunk
# loop a microbatch); an eighth of the depth keeps the script inside its
# 1,200 s (1,044 s there with all 64 layers; ~1,065 s on a slow host with
# 16 layers once the sharded phase joined)
TRAIN_MAMBA_LAYERS = 8
# warmup_cosine(lr0, warmup, total), chosen for this check. Adam's first
# steps move every weight by ~lr in its gradient's sign, so a layer's output
# moves by ~3072 · lr · |x| against its ~|x|: at lr0 6e-4 (step 1 at 3e-4)
# the random bf16 model's loss jumped 12.8 -> 17.7 on the card
TRAIN_LR = (5e-5, 2, TRAIN_WARMUP + TRAIN_TIMED)
TRAIN_EMBED = (2_048, 128)  # documents x tokens the trained model embeds for the map
TRAIN_REDUCED = [
    f"train_4k: global_batch 256 -> {TRAIN_ACCUM * TRAIN_MICRO} ({TRAIN_ACCUM} microbatches of {TRAIN_MICRO}, "
    f"pre-split), seq_len {TRAIN_SEQ:,}; {TRAIN_WARMUP} + {TRAIN_TIMED} steps: the script's time limit; the "
    "profile is of one microbatch's forward and backward (the profiler takes ~5 minutes over a whole step's kernels)",
    f"Mamba-2: {TRAIN_MAMBA_LAYERS} of its 64 layers (the script's time limit: its step is host-bound), the "
    f"same {TRAIN_ACCUM * TRAIN_MICRO} x {TRAIN_SEQ:,} tokens a step at its published accum_steps 8 "
    f"(microbatches of 1), {TRAIN_MAMBA_STEPS} steps, the first untimed",
    "weights: random from a seeded torch.Generator (bf16), not the published checkpoints; TokenStream's "
    "synthetic Zipf tokens, not a text corpus",
    "head_pad_to 16 -> 1, vocab_pad_to 256 -> 1 (one card, no tensor axis; a layout, not a cut)",
    f"card vs CPU: {FWD_LAYERS} of the published layers in fp32, a TokenStream batch of "
    f"{TRAIN_PARITY_BATCH[0]} x {TRAIN_PARITY_BATCH[1]}, accum_steps 1",
    f"the map: the trained Phi-4-mini embeds class_token_corpus({TRAIN_EMBED[0]:,}, {TRAIN_EMBED[1]}) "
    "and pipeline_phi4_mini's map config fits it",
]


def flash_check(device, label: str, H: int, KV: int, hd: int, B: int, S: int, chunk: int, window: int) -> dict:
    """``attend_flash``'s output and q/k/v gradients against autograd through
    ``attend_full`` in float32 (``FLASH_REL`` each), and the device memory
    a forward + backward takes above what it started from, for flash,
    chunked and full."""
    import torch

    from repro_torch.models import attention

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the card's fp32 attention would not be fp32")
    g = torch.Generator(device=device).manual_seed(11)
    q, dout = (torch.randn(B, S, H, hd, generator=g, device=device) for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=device) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)

    def run(fn, **kw):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        out = fn(*ts, pos, pos, causal=True, window=window, **kw)
        grads = torch.autograd.grad(out, ts, dout)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        return [out.detach()] + list(grads), (torch.cuda.max_memory_allocated(device) - base) / 1e9, wall

    flash, flash_gb, flash_s = run(attention.attend_flash, chunk=chunk)
    _, chunked_gb, chunked_s = run(attention.attend_chunked, chunk=chunk)
    full, full_gb, full_s = run(attention.attend_full)
    rel = {n: float((a - b).norm() / b.norm()) for n, a, b in zip(("out", "dq", "dk", "dv"), flash, full)}
    del flash, full
    torch.cuda.empty_cache()
    out = {"shape": label, "heads": H, "kv_heads": KV, "head_dim": hd, "batch": B, "seq": S, "chunk": chunk,
           "window": window, "rel_vs_full": rel, "tol": FLASH_REL, "peak_gb": {"flash": flash_gb,
           "chunked": chunked_gb, "full": full_gb}, "wall_s": {"flash": flash_s, "chunked": chunked_s, "full": full_s}}
    if not max(rel.values()) <= FLASH_REL:
        raise AssertionError(f"flash vs full attention on the card ({label}): {rel}")
    if not flash_gb < chunked_gb:
        raise AssertionError(f"flash's backward peak {flash_gb} GB is not below chunked's {chunked_gb} GB ({label})")
    return out


class RecordSGD:
    """SGD that keeps a copy of the gradients it is given (for a check)."""

    def __init__(self, lr: float):
        from repro_torch.optim import SGD, constant

        self.sgd = SGD(constant(lr))

    def init(self, params):
        return self.sgd.init(params)

    def update_(self, params, grads, state):
        self.grads = [g.clone() for g in grads]
        return self.sgd.update_(params, grads, state)


def train_parity(device, name: str) -> dict:
    """One fp32 train step (accum 1, SGD) of ``name`` at its published widths
    with ``FWD_LAYERS`` layers, on the card and on the port's CPU, from one
    seeded init copied and one TokenStream batch: the loss within
    ``TRAIN_LOSS_REL``, each leaf's gradient and SGD-updated weight within
    ``FWD_FP32_REL``. MoE routes are compared as the forward checks do: a
    difference must be a near-tie, and then the gradients are reported,
    not held (a flipped route is a different function)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import TokenStream
    from repro_torch.models import lm, moe, steps

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the card's fp32 step would not be fp32")
    B, S = TRAIN_PARITY_BATCH
    cfg = chunked(dataclasses.replace(ARCHS[name], n_layers=FWD_LAYERS, head_pad_to=1, vocab_pad_to=1,
                                      param_dtype="float32", compute_dtype="float32", accum_steps=1), S)
    batch = TokenStream(cfg.vocab_size, S).batch(0, B)
    model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(1))
    cpu = copy.deepcopy(model).to("cpu")
    out = {"arch": name, "layers": FWD_LAYERS, "d_model": cfg.d_model, "batch": [B, S], "remat": cfg.remat,
           "params": lm.n_params(model)}
    runs = {}
    for where, m in (("card", model), ("cpu", cpu)):
        opt, routes = RecordSGD(TRAIN_PARITY_LR), []
        t0 = time.perf_counter()
        with moe.route_hook(lambda p, i, k: routes.append((p.detach().float().cpu(), i.cpu(), k.cpu()))):
            _, _, loss = steps.make_train_step(cfg, opt)(m, opt.init(list(m.parameters())), batch)
        loss = float(loss)
        out[f"{where}_step_s"] = time.perf_counter() - t0
        runs[where] = (loss, opt.grads, routes)
    (l_card, g_card, r_card), (l_cpu, g_cpu, r_cpu) = runs["card"], runs["cpu"]
    flips, gaps, same = route_diffs(r_card, r_cpu, B, S)
    if any(gp > ROUTE_TIE for gp in gaps):
        raise AssertionError(f"{name}: routes differ card vs CPU beyond a near-tie: gaps {gaps}")
    names = [n for n, _ in model.named_parameters()]
    g_rel = {n: float((a.cpu() - b).norm() / b.norm()) for n, a, b in zip(names, g_card, g_cpu) if b.norm() > 0}
    w_rel = {n: float((a.detach().cpu() - b.detach()).norm() / b.detach().norm())
             for (n, a), (_, b) in zip(model.named_parameters(), cpu.named_parameters())}
    held = bool(same.all())
    out.update(loss_card=l_card, loss_cpu=l_cpu, loss_rel=abs(l_card - l_cpu) / abs(l_cpu), loss_tol=TRAIN_LOSS_REL,
               grad_rel_max=max(g_rel.values()), grad_rel_worst=max(g_rel, key=g_rel.get),
               weight_rel_max=max(w_rel.values()), tol=FWD_FP32_REL, leaves=len(names),
               routes_checked=sum(int(i.numel()) for _, i, _ in r_card), route_flips=flips, route_flip_gaps=gaps,
               grads_held=held)
    del model, cpu, runs, g_card, g_cpu
    torch.cuda.empty_cache()
    if not out["loss_rel"] <= TRAIN_LOSS_REL:
        raise AssertionError(f"{name}: the fp32 step's loss, card {l_card} vs CPU {l_cpu}")
    if held and not (out["grad_rel_max"] <= FWD_FP32_REL and out["weight_rel_max"] <= FWD_FP32_REL):
        raise AssertionError(f"{name}: card vs CPU gradients up to {out['grad_rel_max']} "
                             f"({out['grad_rel_worst']}), SGD weights up to {out['weight_rel_max']}")
    return out


def quantizer_parity(device) -> dict:
    """The int8 quantiser of AdamW's moments, card ≡ CPU bit for bit, on a
    Phi-4-mini-shaped leaf (3072 x 8192), both scales."""
    import torch

    from repro_torch.optim import quantize_int8

    x = torch.randn(3072, 8192, generator=torch.Generator(device=device).manual_seed(3), device=device) * 0.01
    out = {}
    for sq in (False, True):
        a = quantize_int8(x.abs() if sq else x, sqrt_scaled=sq)
        b = quantize_int8((x.abs() if sq else x).cpu(), sqrt_scaled=sq)
        out["sqrt" if sq else "plain"] = bool(torch.equal(a.q.cpu(), b.q) and torch.equal(a.scale.cpu(), b.scale))
    if not all(out.values()):
        raise AssertionError(f"the int8 quantiser differs card vs CPU: {out}")
    return out


def train_flops(cfg, n_params: int, tokens: int, seqs: int, seq: int) -> tuple:
    """(model FLOPs, hardware FLOPs, the float32 share of the hardware's) of
    one step. Model: 6·N·T, plus causal attention's scores and values
    (half the Sq × Sk square, forward 2 products and backward 4). Hardware:
    what ran: remat reruns every layer's forward (8 instead of 6 a parameter
    and token in the layers, 6 in the vocabulary product outside them)
    except its last product, the SwiGLU's down projection: the rerun stops
    once the tensors the backward saved are back (torch.utils.checkpoint's
    early stop), and nothing saves that product's output. Flash runs every
    (cq, ck) tile, masked or not: forward 2 products, the rerun forward 2,
    the backward's recomputed scores and 4 products, 9 a full square; the
    attention's products are float32 on the CUDA cores."""
    L = cfg.n_layers
    head = cfg.vocab_size * cfg.d_model
    sq = 2.0 * seq * seq * cfg.n_heads * cfg.head_dim  # one product over the full square
    attn_model = L * seqs * 3 * sq  # causal: half of (2 forward + 4 backward) products
    attn_hw = L * seqs * 9 * sq
    model = 6.0 * n_params * tokens + attn_model
    down = 2.0 * cfg.d_model * cfg.d_ff * L * tokens if cfg.remat == "full" else 0.0  # not rerun
    hw = 8.0 * (n_params - head) * tokens - down + 6.0 * head * tokens + attn_hw
    return model, hw, attn_hw


def moment_bytes(state) -> int:
    from repro_torch.optim import QTensor

    n = 0
    for mv in state["mu"]:
        for t in mv.values():
            n += t.q.numel() + t.scale.numel() * 4 if isinstance(t, QTensor) else t.numel() * t.element_size()
    return n


def train_full(device, model, cfg, n_steps: int, timed_from: int, lr) -> tuple:
    """``n_steps`` AdamW steps (the config's moments) of ``model`` on
    TokenStream batches of ``TRAIN_ACCUM * TRAIN_MICRO`` x ``TRAIN_SEQ``
    tokens, pre-split into the config's microbatches, each timed by CUDA
    events (the p50 and p99 from ``timed_from`` on). Then one microbatch's
    forward and backward (the loss and ``torch.autograd.grad``, as the
    step takes them) under the profiler, with no update, so the weights
    have had ``n_steps`` updates when this returns: its busy share and
    largest kernels stand for a step's, which is ``accum_steps`` such
    passes and one update; the profiler takes minutes to sort out a whole
    step's ~10^5-10^6 kernels. Returns (the numbers, the state)."""
    import torch

    from repro_torch.data.loader import TokenStream
    from repro_torch.models import lm, steps
    from repro_torch.optim import AdamW, warmup_cosine

    accum, rows = cfg.accum_steps, TRAIN_ACCUM * TRAIN_MICRO
    opt = AdamW(schedule=warmup_cosine(*lr), moment_dtype=cfg.opt_moment_dtype)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    state = opt.init(list(model.parameters()))
    step = steps.make_train_step(cfg, opt, microbatched=True)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ)

    def batch(i):
        return {k: torch.from_numpy(v.reshape((accum, rows // accum) + v.shape[1:])).to(device)
                for k, v in stream.batch(i, rows).items()}

    losses, events = [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        b = batch(i)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        model, state, loss = step(model, state, b)
        e1.record()
        events.append((e0, e1))
        losses.append(loss)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(device)
    timed = ms[timed_from:]
    loss_fn, mb = steps.make_loss_fn(cfg), {k: v[0] for k, v in batch(n_steps).items()}

    def one():
        with lm.trainable(model) as leaves:
            g = torch.autograd.grad(loss_fn(model, mb)[0], leaves, allow_unused=True, materialize_grads=True)
        del g

    t0 = time.perf_counter()
    prof_wall, prof_dev, top = device_breakdown(device, one, top=10)
    prof_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = rows * TRAIN_SEQ
    mflops, hflops, f32flops = train_flops(cfg, n_params, tokens, rows, TRAIN_SEQ) if cfg.n_heads else (
        6.0 * n_params * tokens, 8.0 * n_params * tokens, 0.0)
    p50, p99 = float(np.percentile(timed, 50)), float(np.percentile(timed, 99))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "params": n_params,
           "dtype": cfg.param_dtype, "remat": cfg.remat, "attn_impl": cfg.attn_impl, "accum_steps": accum,
           "micro": rows // accum, "seq": TRAIN_SEQ, "tokens_per_step": tokens, "moments": cfg.opt_moment_dtype,
           "lr": {"schedule": "warmup_cosine", "lr0": lr[0], "warmup": lr[1], "total_steps": lr[2]},
           "steps": n_steps, "timed_from": timed_from, "losses": losses,
           "step_ms": ms, "step_ms_p50": p50, "step_ms_p99": p99, "wall_s": wall,
           "tokens_per_s": tokens / (p50 / 1e3), "model_flops": mflops, "hardware_flops": hflops,
           "fp32_attention_flops": f32flops, "model_tflops_per_s": mflops / (p50 / 1e3) / 1e12,
           "model_flops_share_bf16": mflops / (p50 / 1e3) / PEAK_BF16_FLOPS,
           "hardware_tflops_per_s": hflops / (p50 / 1e3) / 1e12,
           "fp32_attention_floor_s": f32flops / PEAK_FP32_FLOPS, "profiled": "one microbatch's forward and backward, no update",
           "profiled_wall_s": prof_wall, "profiled_device_s": prof_dev, "profiler_s": prof_s,
           "busy_share": prof_dev / prof_wall, "top_kernels": top, "peak_device_gb": peak / 1e9,
           "held_before_gb": held / 1e9, "moment_bytes": moment_bytes(state),
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{cfg.name}: non-finite loss in {losses}")
    return out, state


def step_determinism(device, cfg) -> dict:
    """Two 2-step runs (AdamW, int8 moments) of ``cfg`` at ``FWD_LAYERS``
    layers from one seeded init on the same two TokenStream batches: are the
    weights bit-equal? If not, which leaves differ, and whether one
    microbatch's gradients already differ between two runs (and where)."""
    import dataclasses

    import torch

    from repro_torch.data.loader import TokenStream
    from repro_torch.models import lm, steps
    from repro_torch.optim import AdamW, warmup_cosine

    small = dataclasses.replace(cfg, n_layers=FWD_LAYERS)
    rows = TRAIN_ACCUM * TRAIN_MICRO
    stream = TokenStream(small.vocab_size, TRAIN_SEQ)
    batches = [{k: torch.from_numpy(v.reshape((TRAIN_ACCUM, TRAIN_MICRO) + v.shape[1:])).to(device)
                for k, v in stream.batch(i, rows).items()} for i in range(2)]

    def run():
        m = lm.init_params(small, generator=torch.Generator(device=device).manual_seed(5))
        opt = AdamW(schedule=warmup_cosine(*TRAIN_LR), moment_dtype=small.opt_moment_dtype)
        st, step = opt.init(list(m.parameters())), steps.make_train_step(small, opt, microbatched=True)
        for b in batches:
            m, st, _ = step(m, st, b)
        return dict(m.named_parameters())

    a, b = run(), run()
    differ = sorted(n for n in a if not torch.equal(a[n], b[n]))
    del a, b
    grads_differ = []
    if differ:
        m = lm.init_params(small, generator=torch.Generator(device=device).manual_seed(5))
        loss_fn = steps.make_loss_fn(small)
        mb = {k: v[0] for k, v in batches[0].items()}
        with lm.trainable(m) as leaves:
            gs = [torch.autograd.grad(loss_fn(m, mb)[0], leaves) for _ in range(2)]
        grads_differ = sorted(n for (n, _), x, y in zip(m.named_parameters(), *gs) if not torch.equal(x, y))
        del m, gs
    torch.cuda.empty_cache()
    return {"layers": FWD_LAYERS, "steps": 2, "bit_equal": not differ, "leaves_differ": differ,
            "one_microbatch_grads_differ": grads_differ}


def train_summary(train: dict) -> dict:
    """The train phase's line: the gates' numbers and the full-depth figures."""
    keep = ("step_ms_p50", "step_ms_p99", "tokens_per_s", "model_tflops_per_s", "model_flops_share_bf16",
            "hardware_tflops_per_s", "busy_share", "peak_device_gb", "moment_bytes", "losses")
    return {"phase_s": train.get("phase_s"), "reduced": train["reduced"],
            "flash": [{k: r[k] for k in ("shape", "rel_vs_full", "peak_gb")} for r in train["flash"]],
            "quantizer_card_equals_cpu": train["quantizer_card_equals_cpu"],
            "parity": [{k: r[k] for k in ("arch", "loss_rel", "grad_rel_max", "weight_rel_max", "grads_held",
                                           "route_flips", "cpu_step_s")} for r in train["parity"]],
            "phi4_mini": {k: train["phi4_mini"][k] for k in keep},
            "mamba2": {k: train["mamba2"][k] for k in keep},
            "map": train["map"], "determinism": train["determinism"], "launches": train["launches"]}


def train_path(device) -> dict:
    """The zoo's training path on the card: flash against full attention,
    the card's fp32 step against the CPU's at 2 layers (Phi-4-mini, Mamba-2,
    Mixtral), Phi-4-mini at full depth in bf16 training with int8 AdamW
    moments, remat and flash, then the trained Phi-4-mini embedding a
    corpus that the port maps, and Mamba-2 with ``TRAIN_MAMBA_LAYERS``
    layers. Launch counts are read around the embed and the map; then
    every kernel of the map is held against its plain version on the
    trained model's rows (``check_path_kernels``)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import PIPELINE_WORKLOADS
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.synthetic import class_token_corpus
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.pipeline import embed_to_store
    from repro_torch.serve import FrozenMap, MapServer

    work = os.path.join(OUT_DIR, "train")
    shutil.rmtree(work, ignore_errors=True)
    out = {"reduced": TRAIN_REDUCED, "flash": [], "parity": []}
    try:
        for label, shape in TRAIN_FLASH.items():
            row = flash_check(device, label, *shape)
            out["flash"].append(row)
            print(json.dumps({"train_flash": row}), flush=True)
        out["quantizer_card_equals_cpu"] = quantizer_parity(device)
        for name in TRAIN_PARITY_ARCHS:
            row = train_parity(device, name)
            out["parity"].append(row)
            print(json.dumps({"train_parity": row}), flush=True)

        # Phi-4-mini at full depth: bf16, remat full, flash, int8 moments
        acfg = dataclasses.replace(pipeline_arch(), remat="full", attn_impl="flash")
        if (acfg.accum_steps, acfg.opt_moment_dtype, acfg.grad_accum_dtype) != (TRAIN_ACCUM, "int8", "float32"):
            raise AssertionError(f"{acfg.name}: accum {acfg.accum_steps}, moments {acfg.opt_moment_dtype}")
        model = lm.init_params(acfg, generator=torch.Generator(device=device).manual_seed(0))
        phi, state = train_full(device, model, acfg, TRAIN_WARMUP + TRAIN_TIMED, TRAIN_WARMUP, TRAIN_LR)
        del state
        torch.cuda.empty_cache()
        print(json.dumps({"train_phi4_mini": phi}), flush=True)
        if not phi["losses"][-1] < phi["losses"][0]:
            raise AssertionError(f"{acfg.name}: the loss did not fall: {phi['losses']}")
        out["phi4_mini"] = phi

        # the trained model embeds a corpus, and the port maps it
        docs, classes = class_token_corpus(*TRAIN_EMBED, acfg.vocab_size, n_classes=PIPE_CLASSES, seed=4)
        wl = PIPELINE_WORKLOADS[PIPE_WORKLOAD]
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        store = embed_to_store(model, acfg, docs, os.path.join(work, "embeddings"), pool="mean",
                               doc_batch=PIPE_DOC_BATCH)
        embed_s = time.perf_counter() - t0
        x = store.materialize()
        if x.shape != (TRAIN_EMBED[0], acfg.d_model) or not np.isfinite(x).all():
            raise AssertionError(f"the trained model's store holds {x.shape}, finite {np.isfinite(x).all()}")
        ncfg = wl.nomad_config(TRAIN_EMBED[0], acfg.d_model, seed=0)
        t0 = time.perf_counter()
        fit = NomadProjection(ncfg, device=device).fit(store)
        fit_s = time.perf_counter() - t0
        out["launches"] = registry.launch_counts()
        if not all(out["launches"][n] for n in FIT_KERNELS):
            raise AssertionError(f"the trained model's map launched {out['launches']}")
        if not np.isfinite(fit.embedding).all():
            raise AssertionError("the trained model's map is not finite")
        # every kernel of the map against its plain version on the trained
        # model's rows, the rows themselves served as the queries
        frozen = FrozenMap.from_fit(fit, ncfg, device=device)
        xd = torch.from_numpy(x).to(device)
        kernels = check_path_kernels(device, fit, frozen, xd, xd, MapServer(frozen).transform(x, seed=7).embedding,
                                     random=False)
        out["map"] = {"docs": list(TRAIN_EMBED), "embed_s": embed_s, "fit_s": fit_s, "n_clusters": ncfg.n_clusters,
                      "epochs": ncfg.n_epochs, "knn_class_agreement": knn_class_agreement(fit.embedding, classes, device),
                      "launches": out["launches"], "kernels": kernels}
        print(json.dumps({"train_map": out["map"]}, default=str), flush=True)
        shutil.rmtree(os.path.join(work, "embeddings"), ignore_errors=True)
        del model, store, fit, frozen, xd
        torch.cuda.empty_cache()

        out["determinism"] = step_determinism(device, acfg)
        print(json.dumps({"train_determinism": out["determinism"]}), flush=True)

        # Mamba-2 at its published widths and accum_steps, TRAIN_MAMBA_LAYERS deep
        mcfg = dataclasses.replace(mamba_arch(), remat="full", n_layers=TRAIN_MAMBA_LAYERS)
        model = lm.init_params(mcfg, generator=torch.Generator(device=device).manual_seed(0))
        mamba, state = train_full(device, model, mcfg, TRAIN_MAMBA_STEPS, 1, TRAIN_LR)
        del state, model
        torch.cuda.empty_cache()
        print(json.dumps({"train_mamba2": mamba}), flush=True)
        out["mamba2"] = mamba
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The launcher (crash and resume) and the dry run
# ---------------------------------------------------------------------------

LAUNCH_WORKLOAD = "nomad_pubmed"
LAUNCH_N = 262_144
LAUNCH_EPOCHS = 4
LAUNCH_FAIL_AT = 3  # the crash run exits at the start of this epoch
LAUNCH_ASSIGN_MIN = 0.99  # kmeans_fit's assignment ≡ the plain nearest centroid (the repo's rule)
LAUNCH_REDUCED = [
    f"n_points 24,000,000 -> {LAUNCH_N:,} (three fits and two index builds inside the phase's time)",
    f"n_epochs 60 -> {LAUNCH_EPOCHS} (a checkpoint every epoch, the crash at the start of epoch {LAUNCH_FAIL_AT})",
    f"data: hierarchical_mixture({LAUNCH_N:,}, 768, seed 0), the launcher's own, in place of PubMed BERT vectors",
]
DRYRUN_FLOP_REL = 0.05  # the op counter's matrix-product FLOPs against train_flops' hardware count


def _launcher(argv, *, in_process: bool, module: str = "repro_torch.launch.train"):
    """One run of ``python -m <module> argv``: (return code, stdout, wall
    s, the fit's stage times). In process through the module's ``main``
    (stdout captured), else a child process."""
    import contextlib
    import importlib
    import io

    t0 = time.perf_counter()
    if in_process:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(module).main(argv)
        text = buf.getvalue()
    else:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        r = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True,
                           text=True, timeout=900, env=env, cwd=ROOT)
        rc, text = r.returncode, r.stdout + r.stderr[-4000:]
    wall = time.perf_counter() - t0
    stages = [json.loads(ln[len("stages "):]) for ln in text.splitlines() if ln.startswith("stages ")]
    return rc, text, wall, stages[0] if stages else None


def launch_path(device) -> dict:
    """The one-card launcher at PubMed's widths (``LAUNCH_REDUCED``): an
    uninterrupted run in process through ``launch.train.main`` with K1-K3's
    launches read around it; a child crashed at the start of epoch
    ``LAUNCH_FAIL_AT`` (exit 17) and a child resumed from its asynchronous
    checkpoint (``index: cache``, ``resume: epoch 2`` or ``3``) whose
    embedding must equal the uninterrupted run's bit for bit; then on the
    same data ``build_index`` ≡ ``IndexBuilder.build`` bit for bit and
    ``kmeans_fit`` (K2 launched, its assignment ≡ the plain nearest centroid
    of its centroids on ≥ ``LAUNCH_ASSIGN_MIN`` of the rows, counts its
    bincount)."""
    import shutil

    import torch

    from repro_torch.configs import get_nomad
    from repro_torch.data.synthetic import hierarchical_mixture
    from repro_torch.index import IndexBuilder, build_index, kmeans_fit
    from repro_torch.kernels import registry
    from repro_torch.kernels.kmeans_assign import ops as k2_ops
    from repro_torch.kernels.kmeans_assign.ops import assign_nearest_plain

    work = os.path.join(OUT_DIR, "launch")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    common = ["--workload", LAUNCH_WORKLOAD, "--n-points", str(LAUNCH_N), "--epochs", str(LAUNCH_EPOCHS),
              "--checkpoint-every", "1"]
    out = {"reduced": LAUNCH_REDUCED, "runs": {}}
    t_phase = time.perf_counter()
    try:
        emb_a, emb_b = os.path.join(work, "uninterrupted.npy"), os.path.join(work, "resumed.npy")
        registry.reset_launch_counts()
        rc, text, wall, stages = _launcher(common + ["--checkpoint-dir", os.path.join(work, "a"), "--out", emb_a],
                                           in_process=True)
        launches = registry.launch_counts()
        out["runs"]["uninterrupted"] = {"rc": rc, "wall_s": wall, "stage_s": stages}
        out["launches"] = launches
        if rc != 0 or "index: local" not in text:
            raise AssertionError(f"the uninterrupted launch returned {rc}:\n{text[-3000:]}")
        if not all(launches[n] for n in FIT_KERNELS):
            raise AssertionError(f"the launcher's fit launched {launches}")
        ck_b = ["--checkpoint-dir", os.path.join(work, "b")]
        rc, text, wall, stages = _launcher(common + ck_b + ["--fail-at-epoch", str(LAUNCH_FAIL_AT)], in_process=False)
        out["runs"]["crash"] = {"rc": rc, "wall_s": wall, "stage_s": stages}
        if rc != 17 or f"CRASH INJECTION at epoch {LAUNCH_FAIL_AT}" not in text:
            raise AssertionError(f"the crash run returned {rc}, not 17:\n{text[-3000:]}")
        rc, text, wall, stages = _launcher(common + ck_b + ["--resume", "--out", emb_b, "--metrics"], in_process=False)
        resumed_at = [ln for ln in text.splitlines() if ln.startswith("resume: ")]
        metrics = [ln for ln in text.splitlines() if ln.startswith("NP@10=")]
        out["runs"]["resume"] = {"rc": rc, "wall_s": wall, "stage_s": stages, "resume_line": resumed_at,
                                 "metrics_line": metrics}
        if rc != 0 or "index: cache" not in text or not any(
                f"resume: epoch {e} " in ln for ln in resumed_at for e in (LAUNCH_FAIL_AT - 1, LAUNCH_FAIL_AT)):
            raise AssertionError(f"the resumed run returned {rc}:\n{text[-3000:]}")
        a, b = np.load(emb_a), np.load(emb_b)
        out["resumed_equals_uninterrupted"] = bool(a.shape == (LAUNCH_N, 2) and np.array_equal(a, b))
        if not out["resumed_equals_uninterrupted"] or not np.isfinite(a).all():
            raise AssertionError(f"the resumed embedding differs from the uninterrupted one "
                                 f"({int((a != b).any(1).sum())} rows)")

        # the front doors on the same data
        cfg = get_nomad(LAUNCH_WORKLOAD).replace(n_points=LAUNCH_N)
        x, _sup, _sub = hierarchical_mixture(cfg.n_points, cfg.dim, seed=cfg.seed)
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        i1 = build_index(x, cfg, device=device)
        build_s = time.perf_counter() - t0
        build_launches = registry.launch_counts()
        builder = IndexBuilder(cfg, device=device)
        i2 = builder.build(x)
        fields = ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm")
        same = {f: bool(np.array_equal(getattr(i1, f), getattr(i2, f))) for f in fields}
        out["build_index"] = {"wall_s": build_s, "stage_s": builder.report.stage_s, "launches": build_launches,
                              "equals_index_builder": same}
        if not all(same.values()) or not (build_launches["kmeans_assign"] and build_launches["pairwise"]):
            raise AssertionError(f"build_index ≢ IndexBuilder.build: {same}, launches {build_launches}")
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        cents, assign, counts = kmeans_fit(cfg.seed, x, cfg.n_clusters, n_iters=cfg.kmeans_iters, tol=cfg.kmeans_tol,
                                           device=device)
        torch.cuda.synchronize(device)
        km_s = time.perf_counter() - t0
        km_launches = registry.launch_counts()
        xd = torch.from_numpy(x).to(device)
        plain = torch.cat([assign_nearest_plain(xd[s : s + 16384], cents)[0] for s in range(0, LAUNCH_N, 16384)])
        share = float((plain == assign).float().mean())
        counts_ok = bool(torch.equal(counts, torch.bincount(assign.long(), minlength=cfg.n_clusters).float())
                         and int(counts.sum()) == LAUNCH_N)
        # the rows that differ: is K2's pick as near as the plain one, by K2's oracle tolerance?
        diff = (plain != assign).nonzero()[:, 0]
        d_k2 = torch.sum(torch.square(xd[diff] - cents[assign[diff].long()]), -1)
        d_plain = torch.sum(torch.square(xd[diff] - cents[plain[diff].long()]), -1)
        rtol, atol = k2_ops.TOL
        near = float(((d_k2 - d_plain).abs() <= atol + rtol * d_plain.abs()).float().mean()) if len(diff) else 1.0
        out["kmeans_fit"] = {"wall_s": km_s, "launches": km_launches, "assign_equals_plain": share,
                             "differing_rows_near_ties": near, "counts_are_bincount": counts_ok,
                             "empty_clusters": int((counts == 0).sum())}
        if not km_launches["kmeans_assign"] or share < LAUNCH_ASSIGN_MIN or not counts_ok:
            raise AssertionError(f"kmeans_fit: {out['kmeans_fit']}")
        del xd, plain, d_k2, d_plain
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# The sharded path: the multi-GPU NOMAD side on shard slots of one card
# ---------------------------------------------------------------------------

SHARDED_SLOTS = 4
SHARDED_Q = 8_192  # queries served on the 4-slot map: 2 batches of 4 × serve_microbatch
SHARDED_ASSIGN_MIN = 0.99  # the 4-slot build ≡ the local assignment on its centroids (the repo's rule)
SHARDED_K1_SLOTS = (2, 3)  # K1 checked at flat slot 2 (own cells at 2,048) and 2×2 slot 3 (pod 1, own at 1,024)
SHARDED_REDUCED = LAUNCH_REDUCED + [
    f"{SHARDED_SLOTS} shard slots on one card (the slots run one after another; the mean and bid "
    "exchanges cross no wire); NCCL at world size 1, since NCCL takes one process a card",
]


def check_sharded_k1(device, cfg, fit, strategy, shard: int) -> dict:
    """K1 against its plain version at one shard slot's step, on the inputs
    the sharded epoch gives it there: ``strategy`` (sharded or
    hierarchical, over the phase's mesh) prepares the blocks of the fit's
    θ, every block's cell means go through ``cell_exchange`` as at a
    refresh, and slot ``shard`` draws step 0 of epoch 0 with its own key.
    That step runs once through ``step_update`` on a copy of the slot's
    block while ``losses.nomad_step_term`` records its arguments: the
    exchanged means and weights, and the own cells at ``cl + own_base``.
    The kernel and its plain version then run on exactly those arguments,
    within K1's tolerance (scaled at R ≥ 4096 means, as on the fit's
    data); a disagreement is fatal."""
    import torch

    from repro_torch.core import losses
    from repro_torch.core.distributed import cell_exchange, step_key
    from repro_torch.core.nomad import local_means, sample_step_rows, step_update
    from repro_torch.index.build import seeded_generator
    from repro_torch.kernels.nomad_step import ops as k1

    index, C = fit.index, cfg.cluster_capacity
    rows = np.zeros((index.n_clusters * C, fit.embedding.shape[1]), np.float32)
    rows[index.perm] = fit.embedding
    theta = strategy.prepare(cfg, "nomad", index, rows, device)
    scfg, idx, n = strategy.cfg, strategy.idx, strategy.n_shards
    n_pods = strategy.mesh.shape[strategy.pod_axis] if strategy.pod_axis else 1
    means = [local_means(theta[s], idx[s]["counts"], C) for s in range(n)]
    cell_means, cell_w, own_base = cell_exchange(
        means, strategy.counts_global[shard], shard, n_noise=scfg.n_noise, n_total=scfg.n_points, n_pods=n_pods,
        hierarchical=scfg.hierarchical and strategy.pod_axis is not None)
    gen = seeded_generator(device, *step_key(scfg, 0, shard, 0, n))
    r, cl, neg = sample_step_rows(gen, idx[shard], scfg, "nomad")
    seen, real = [], losses.nomad_step_term

    def record(*a):
        seen.append([t.detach() for t in a])
        return real(*a)

    losses.nomad_step_term = record
    try:
        step_update(theta[shard].clone(), idx[shard], cell_means, idx[shard]["counts"], 1.0, r, cl, neg, cfg=scfg,
                    cell_w=cell_w, own_base=own_base)
    finally:
        losses.nomad_step_term = real
    got = seen[0]  # cast as nomad_step_fused casts them
    args = tuple(t.float().contiguous() for t in got[:7]) + (got[7].to(torch.int32).contiguous(),)
    B, R = args[0].shape[0], args[5].shape[0]
    if not (torch.equal(args[5], cell_means) and torch.equal(args[6], cell_w)
            and torch.equal(got[7], cl + own_base)):
        raise AssertionError(f"slot {shard}'s step did not take its exchange's means, weights and own cells")
    shape = (B, args[1].shape[1], args[3].shape[1], R, args[0].shape[1])
    errs = _check_pair(f"nomad_step at {strategy.name} slot {shard}, {shape}",
                       nomad_pair(args, torch.full((B,), 1.0 / B, device=device)), k1.TOL, R >= 4096)
    return {"slot": shard, "shape": shape, "means": R, "own_base": own_base, "plan": k1.plan(R),
            "max_abs_err": errs}


def sharded_path(device) -> dict:
    """The multi-GPU NOMAD side on ``SHARDED_SLOTS`` shard slots of one
    card, at PubMed's widths on the launch phase's data
    (``SHARDED_REDUCED``). The phase's main path, counted: the 4-slot build
    (counts ≤ C, no kNN edge leaves its slot, its assignment ≡ the local
    one on its centroids on ≥ ``SHARDED_ASSIGN_MIN`` of rows), the 4-slot
    flat fit on that index (finite, loss falls, a rerun bit-equal) and
    4-slot serving of ``SHARDED_Q`` queries (≡ local serving bit for bit).
    Beside it: 1 slot ≡ the local fit bit for bit; the 2×2 hierarchical fit
    (finite, loss falls); ``python -m repro_torch.launch.distributed
    --num-processes 1 --host-devices 4`` under NCCL ≡ the in-process
    build and fit bit for bit; every kernel against its plain version on
    the phase's data, and K1 also at the inputs of a flat slot and a 2×2
    slot (``check_sharded_k1``, ``SHARDED_K1_SLOTS``)."""
    import shutil

    import torch

    from repro_torch.configs import get_nomad
    from repro_torch.core.distributed import shard_index_arrays
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.strategy import HierarchicalStrategy, ShardedStrategy
    from repro_torch.data.synthetic import hierarchical_mixture
    from repro_torch.index.build import IndexBuilder, capacity_assign_device
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import flat_mesh, make_mesh
    from repro_torch.serve import FrozenMap, MapServer

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = get_nomad(LAUNCH_WORKLOAD).replace(n_points=LAUNCH_N, n_epochs=LAUNCH_EPOCHS)
    x, _sup, _sub = hierarchical_mixture(cfg.n_points, cfg.dim, seed=cfg.seed)
    q = hierarchical_mixture(SHARDED_Q, cfg.dim, seed=cfg.seed + 1)[0]
    flat, pods = flat_mesh("data", [device] * SHARDED_SLOTS), make_mesh((2, 2), ("pod", "data"), [device] * 4)
    C = cfg.cluster_capacity
    out = {"reduced": SHARDED_REDUCED, "slots": SHARDED_SLOTS, "walls_s": {}}
    walls = out["walls_s"]

    def timed(label, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(device)
        walls[label] = time.perf_counter() - t0
        return r

    try:
        # the phase's main path, its launches counted
        registry.reset_launch_counts()
        builder = IndexBuilder(cfg, strategy="sharded", mesh=flat, device=device)
        index = timed("build_4", lambda: builder.build(x))
        fit4 = timed("fit_4", lambda: NomadProjection(cfg, strategy="sharded", mesh=flat, device=device).fit(
            x, index=index))
        frozen = FrozenMap.from_fit(fit4, cfg, device=device)
        served = timed("serve_4", lambda: MapServer(frozen, strategy="sharded", mesh=flat).transform(q, seed=5))
        out["launches"] = registry.launch_counts()
        missing = [n for n in FIT_KERNELS + SERVE_KERNELS[2:] if out["launches"][n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the sharded path: {missing}")

        # the build
        out["build"] = {"stage_s": builder.report.stage_s, "n_shards": builder.report.n_shards,
                        "stragglers": builder.report.stragglers, "max_count": int(index.counts.max()), "capacity": C}
        shard_index_arrays(index, SHARDED_SLOTS)  # raises on an edge that leaves its slot
        if not (builder.report.n_shards == SHARDED_SLOTS and int(index.counts.max()) <= C
                and int(index.counts.sum()) == cfg.n_points):
            raise AssertionError(f"the 4-slot build: {out['build']}")
        same = timed("assign_local", lambda: capacity_assign_device(
            x, index.centroids, C, device=device, block=cfg.build_block_rows, max_rounds=cfg.build_max_rounds,
            n_cand=cfg.build_candidates))
        out["build"]["assign_equals_local"] = float(np.mean(same == index.perm // C))
        if out["build"]["assign_equals_local"] < SHARDED_ASSIGN_MIN:
            raise AssertionError(f"the 4-slot build's assignment ≡ local on {out['build']['assign_equals_local']}")

        # the fits
        def check_fit(label, res):
            emb = res.embedding
            ok = emb.shape == (cfg.n_points, 2) and bool(np.isfinite(emb).all()) and res.losses[-1] < res.losses[0]
            out[label] = {"losses": res.losses, "epoch_s": res.epoch_times, "stage_s": res.stage_s,
                          "strategy": res.strategy, "n_shards": res.n_shards, "mesh_shape": res.mesh_shape}
            if not ok:
                raise AssertionError(f"{label}: finite {bool(np.isfinite(emb).all())}, losses {res.losses}")

        check_fit("fit_4", fit4)
        again = timed("fit_4_rerun", lambda: NomadProjection(cfg, strategy="sharded", mesh=flat, device=device).fit(
            x, index=index))
        out["fit_4"]["rerun_bit_equal"] = bool(np.array_equal(again.embedding, fit4.embedding))
        if not out["fit_4"]["rerun_bit_equal"]:
            raise AssertionError("two 4-slot fits from one seed and index differ")
        registry.reset_launch_counts()
        hier = timed("fit_2x2", lambda: NomadProjection(cfg, strategy="hierarchical", mesh=pods, device=device).fit(
            x, index=index))
        out["launches_2x2"] = registry.launch_counts()
        check_fit("fit_2x2", hier)
        if not (out["launches_2x2"]["nomad_step_fwd"] and out["launches_2x2"]["nomad_step_bwd"]):
            raise AssertionError(f"the 2x2 fit launched {out['launches_2x2']}")
        local = timed("fit_local", lambda: NomadProjection(cfg, strategy="local", device=device).fit(x, index=index))
        one = timed("fit_1", lambda: NomadProjection(cfg, strategy="sharded", mesh=flat_mesh("data", [device]),
                                                     device=device).fit(x, index=index))
        out["one_slot_equals_local"] = bool(np.array_equal(one.embedding, local.embedding)
                                            and one.losses == local.losses)
        if not out["one_slot_equals_local"]:
            raise AssertionError(f"1 slot ≢ local: losses {one.losses} vs {local.losses}")

        # serving
        want = timed("serve_local", lambda: MapServer(frozen).transform(q, seed=5))
        out["serve_4"] = {"queries": SHARDED_Q, "batch_rows": SHARDED_SLOTS * cfg.serve_microbatch,
                          "p50_batch_s": served.p50_latency_s, "batch_latency_s": served.batch_latency_s}
        out["serve_4"]["equals_local"] = all(np.array_equal(getattr(served, f), getattr(want, f)) for f in (
            "embedding", "cells", "neighbor_ids", "neighbor_dists"))
        if not (out["serve_4"]["equals_local"] and np.isfinite(served.embedding).all()):
            raise AssertionError("4-slot serving ≢ local serving")

        # the launcher under NCCL, one process of 4 slots
        emb_path, idx_path = os.path.join(work, "emb.npy"), os.path.join(work, "index.npz")
        rc, text, wall, stages = _launcher(
            ["--workload", LAUNCH_WORKLOAD, "--n-points", str(LAUNCH_N), "--epochs", str(LAUNCH_EPOCHS),
             "--num-processes", "1", "--host-devices", str(SHARDED_SLOTS), "--out", emb_path, "--dump-index",
             idx_path], in_process=False, module="repro_torch.launch.distributed")
        walls["launcher_child"] = wall
        fit_line = [ln for ln in text.splitlines() if ln.startswith("fit: ")]
        out["launcher"] = {"rc": rc, "fit_line": fit_line, "stage_s": stages}
        if rc != 0 or not fit_line or "processes=1" not in fit_line[0] or "backend=nccl" not in fit_line[0]:
            raise AssertionError(f"the NCCL launcher returned {rc}:\n{text[-3000:]}")
        got = np.load(idx_path)
        same_idx = {k: bool(np.array_equal(got[k], getattr(index, k))) for k in (
            "knn_idx", "knn_w", "counts", "centroids", "perm")}
        out["launcher"]["index_equals_in_process"] = same_idx
        out["launcher"]["embedding_equals_in_process"] = bool(np.array_equal(np.load(emb_path), fit4.embedding))
        if not (all(same_idx.values()) and out["launcher"]["embedding_equals_in_process"]):
            raise AssertionError(f"the NCCL launcher ≢ the in-process 4-slot build and fit: {same_idx}")

        # every kernel against its plain version on the phase's data
        xd = torch.from_numpy(x).to(device)
        qd = torch.from_numpy(q).to(device)
        out["kernels"] = check_path_kernels(device, fit4, frozen, xd, qd, served.embedding, random=False)
        del xd, qd
        # K1 at the slots' own inputs: a flat slot past the first (own cells
        # at 2·K/4) and a 2×2 slot of the second pod (R = K/2 + 2 means)
        out["k1_slots"] = {
            "flat": check_sharded_k1(device, cfg, fit4, ShardedStrategy(mesh=flat), SHARDED_K1_SLOTS[0]),
            "2x2": check_sharded_k1(device, cfg, hier, HierarchicalStrategy(mesh=pods), SHARDED_K1_SLOTS[1])}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# The LM side of multi-GPU on shard slots of one card, and the autotuner
# ---------------------------------------------------------------------------

EP_ARCH = "mixtral-8x7b"
EP_LAYERS = 2
EP_TOKENS = (2, 1_024)  # sequences x tokens through lm.forward
EP_MESHES = {"true_ep": (1, 4), "f_split": (1, 16)}  # (data, model): 2 experts a slot; 896 columns of F a slot
EP_SHARED_ARCH = "llama4-scout-17b-a16e"  # its MoE block with the shared expert, at (1, 4)
SHARDED_DECODE = (16, 2_048, 32)  # Phi-4-mini: prompts, prompt tokens, decode steps
SHARDED_DECODE_SLOTS = 4  # the cache length over 4 model slots
RING_DECODE = (1, 8_190, 6)  # Mixtral past its 4,096-token window: batch 1, the length over all 4 slots
GPIPE_ARCH = "qwen3-14b"
GPIPE = (8, 4, 6, 2, 512)  # layers, stages, microbatches, sequences a microbatch, tokens
COMPRESS_SLOTS = 4
COMPRESS_STEPS = 3
COMPRESS_RTOL, COMPRESS_ATOL = 1e-5, 1e-4  # tests/test_optim.py's telescoping bound
LM_SHARDED_REDUCED = [
    f"{EP_ARCH}: {EP_LAYERS} of 32 layers, {EP_TOKENS[0]} x {EP_TOKENS[1]:,} tokens, random weights "
    "(fp32 and their bf16 cast)",
    f"{EP_SHARED_ARCH}: its MoE block alone (one of 48 layers), {EP_TOKENS[0]} x {EP_TOKENS[1]:,} tokens, bf16",
    f"phi4-mini-3.8b: {FWD_LAYERS} of 32 layers, {SHARDED_DECODE[0]} prompts of {SHARDED_DECODE[1]:,}, "
    f"{SHARDED_DECODE[2]} decode steps; {EP_ARCH}'s ring: batch 1, a prompt of {RING_DECODE[1]:,}, "
    f"{RING_DECODE[2]} steps",
    f"{GPIPE_ARCH}: {GPIPE[0]} of 40 layers, {GPIPE[1]} stages x {GPIPE[0] // GPIPE[1]} layers, {GPIPE[2]} "
    f"microbatches of {GPIPE[3]} x {GPIPE[4]}",
    f"compressed all-reduce: {COMPRESS_SLOTS} data slots, each a random gradient shaped as one phi4-mini "
    f"layer's leaves, {COMPRESS_STEPS} steps",
    "every mesh's slots share the one card: no wire between cards is measured",
]


def _published(name: str, **kw):
    """``name`` at its published widths, heads and vocabulary unpadded
    (one card has no tensor axis to divide)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[name], head_pad_to=1, vocab_pad_to=1, **kw)


def _rel_rows(got, want):
    """Each row's ‖Δ‖/‖want‖ over the last axis (a token's, or a step's logits)."""
    return ((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)).cpu()


def ep_check(device) -> dict:
    """``moe_ep`` through ``lm.forward`` (``set_ep_mesh``) against
    ``moe_sort`` on Mixtral at its widths: true EP on (1, 4) ≡ sort bit for
    bit in fp32 and bf16 (top-2: a token sums at most two nonzero terms);
    the F split on (1, 16) within ``FWD_FP32_REL`` a token in fp32; Scout's
    MoE block with its shared expert on (1, 4) ≡ sort. Returns the fp32
    model for the ring decode."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, moe

    cfg = _published(EP_ARCH, n_layers=EP_LAYERS, param_dtype="float32", compute_dtype="float32")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, EP_TOKENS).astype(np.int32)
    model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(3))
    meshes = {k: make_mesh(s, ("data", "model"), [device] * int(np.prod(s))) for k, s in EP_MESHES.items()}
    out = {"arch": EP_ARCH, "layers": EP_LAYERS, "tokens": list(EP_TOKENS), "meshes": EP_MESHES}

    def forward(m, c, mesh):
        moe.set_ep_mesh(mesh, ("data",))
        try:
            t0 = time.perf_counter()
            logits, aux, _ = lm.forward(m, c, tokens=torch.from_numpy(toks).to(device))
            torch.cuda.synchronize(device)
            return logits, float(aux), time.perf_counter() - t0
        finally:
            moe.set_ep_mesh(None, ())

    ref, aux_ref, out["sort_s"] = forward(model, cfg, None)
    ep, aux_ep, out["true_ep_s"] = forward(model, cfg, meshes["true_ep"])
    out["true_ep_fp32_bit_equal"] = bool(torch.equal(ep, ref)) and aux_ep == aux_ref
    out["true_ep_fp32_max_abs"] = _max_err(ep, ref)
    fs, aux_fs, out["f_split_s"] = forward(model, cfg, meshes["f_split"])
    rel = _rel_rows(fs, ref)
    out["f_split_fp32_rel_max"], out["f_split_aux"] = float(rel.max()), (aux_fs, aux_ref)
    del ep, fs
    cfg16 = _published(EP_ARCH, n_layers=EP_LAYERS)
    m16 = lm.cast(model, cfg16)
    ref16, aux16, _ = forward(m16, cfg16, None)
    ep16, aux_ep16, out["true_ep_bf16_s"] = forward(m16, cfg16, meshes["true_ep"])
    out["true_ep_bf16_bit_equal"] = bool(torch.equal(ep16, ref16)) and aux_ep16 == aux16
    del m16, ref16, ep16, ref
    torch.cuda.empty_cache()
    if not (out["true_ep_fp32_bit_equal"] and out["true_ep_bf16_bit_equal"]):
        raise AssertionError(f"true EP on (1, 4) ≢ moe_sort: {out}")
    if not (out["f_split_fp32_rel_max"] <= FWD_FP32_REL and abs(aux_fs - aux_ref) <= 1e-6):
        raise AssertionError(f"the F split on (1, 16) against moe_sort: {out}")

    scfg = _published(EP_SHARED_ARCH)
    block = moe.init_moe(torch.Generator(device=device).manual_seed(4), scfg)
    x = torch.randn((*EP_TOKENS, scfg.d_model), generator=torch.Generator(device=device).manual_seed(5),
                    device=device).to(block.w_gate.dtype)
    y_sort, a_sort = moe.moe_sort(block, x, scfg)
    moe.set_ep_mesh(meshes["true_ep"], ("data",))
    try:
        y_ep, a_ep = moe.moe_block(block, x, scfg)
    finally:
        moe.set_ep_mesh(None, ())
    out["scout_shared"] = {"experts": scfg.n_experts, "top_k": scfg.top_k, "d_model": scfg.d_model,
                           "d_ff": scfg.d_ff, "shared": scfg.n_shared_experts,
                           "bit_equal": bool(torch.equal(y_ep, y_sort) and torch.equal(a_ep, a_sort))}
    del block, x, y_sort, y_ep
    torch.cuda.empty_cache()
    if not out["scout_shared"]["bit_equal"]:
        raise AssertionError(f"{EP_SHARED_ARCH}'s MoE block on (1, 4) ≢ moe_sort")
    return out, model, cfg


def _decode_pair(device, model, cfg, toks, P: int, steps: int, mesh, batch_axes, s_axes) -> tuple:
    """Prefill ``P`` tokens once, then ``steps`` decode steps from copies of
    that cache, unsharded and with the length-sharded context: the two
    runs' logits (B, steps, V) and their walls."""
    import torch

    from repro_torch.models import attention, lm, steps as lm_steps

    B = toks.shape[0]
    _, stacked = lm_steps.make_prefill_step(chunked(cfg, P))(model, {"tokens": toks[:, :P]})
    cache = lm.load_cache_from_prefill(cfg, lm.init_cache(cfg, B, P + steps, filled=P, device=device), stacked, P)
    del stacked
    runs = {}
    for label, ctx in (("plain", None), ("sharded", mesh)):
        c = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()}
        attention.set_decode_context(ctx, batch_axes, s_axes)
        try:
            t0, got = time.perf_counter(), []
            for t in range(P, P + steps):
                logits, c = lm.decode_step(model, cfg, c, toks[:, t : t + 1])
                got.append(logits[:, 0])
            torch.cuda.synchronize(device)
            runs[label] = (torch.stack(got, 1), time.perf_counter() - t0)
        finally:
            attention.set_decode_context(None, None, ())
        del c
    slots = int(cache["k"].shape[2])
    del cache
    return runs["plain"], runs["sharded"], slots


def decode_sharded_check(device, mixtral, mixtral_cfg) -> dict:
    """``attend_decode_sharded`` through ``decode_step``: Phi-4-mini at its
    widths (2 layers), the cache length over 4 model slots, ≡ the unsharded
    decode within ``FWD_FP32_REL`` a step's logits in fp32 and within
    ``FWD_BF16_REL_MEDIAN``/``_MAX`` in bf16; Mixtral's SWA ring across a wrap (batch 1,
    the length over every slot, batch axes None) in fp32."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm

    mesh = make_mesh((1, SHARDED_DECODE_SLOTS), ("data", "model"), [device] * SHARDED_DECODE_SLOTS)
    B, P, n = SHARDED_DECODE
    cfg = _published("phi4-mini-3.8b", n_layers=FWD_LAYERS, param_dtype="float32", compute_dtype="float32")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, P + n)).astype(np.int32)
    model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(6))
    (plain, t_plain), (shard, t_shard), slots = _decode_pair(device, model, cfg, toks, P, n, mesh, ("data",),
                                                             ("model",))
    rel = _rel_rows(shard, plain)
    out = {"phi4_mini": {"batch": B, "prompt": P, "steps": n, "cache_slots": slots, "slot_block": slots // 4,
                         "fp32_rel_max": float(rel.max()), "plain_s": t_plain, "sharded_s": t_shard}}
    cfg16 = _published("phi4-mini-3.8b", n_layers=FWD_LAYERS)
    m16 = lm.cast(model, cfg16)
    del model
    (p16, _), (s16, _), _ = _decode_pair(device, m16, cfg16, toks, P, n, mesh, ("data",), ("model",))
    rel16 = _rel_rows(s16, p16)
    out["phi4_mini"].update(bf16_rel_median=float(rel16.median()), bf16_rel_max=float(rel16.max()),
                            bf16_argmax_equal=float((s16.argmax(-1) == p16.argmax(-1)).float().mean()))
    del m16, p16, s16, plain, shard
    torch.cuda.empty_cache()
    if not (out["phi4_mini"]["fp32_rel_max"] <= FWD_FP32_REL and out["phi4_mini"]["bf16_rel_median"]
            <= FWD_BF16_REL_MEDIAN and out["phi4_mini"]["bf16_rel_max"] <= FWD_BF16_REL_MAX):
        raise AssertionError(f"the length-sharded decode against the unsharded one: {out['phi4_mini']}")

    B, P, n = RING_DECODE
    toks = np.random.default_rng(7).integers(0, mixtral_cfg.vocab_size, (B, P + n)).astype(np.int32)
    (plain, _), (shard, _), slots = _decode_pair(device, mixtral, mixtral_cfg, toks, P, n, mesh, None,
                                                 ("data", "model"))
    wraps = P > slots and any((t % slots) == 0 for t in range(P, P + n))
    out["mixtral_ring"] = {"batch": B, "prompt": P, "steps": n, "cache_slots": slots, "window":
                           mixtral_cfg.sliding_window, "wraps": wraps,
                           "fp32_rel_max": float(_rel_rows(shard, plain).max())}
    del plain, shard
    torch.cuda.empty_cache()
    if not (wraps and out["mixtral_ring"]["fp32_rel_max"] <= FWD_FP32_REL):
        raise AssertionError(f"the sharded decode across Mixtral's ring: {out['mixtral_ring']}")
    return out


def gpipe_check(device) -> dict:
    """``gpipe`` over 4 stage slots: Qwen3-14B's layers at their widths
    (bf16), 4 stages x 2 layers, 6 microbatches ≡ the 8 layers applied in
    sequence, bit for bit; the schedule's T = 6 + 4 − 1."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import gpipe, stack_stage_params
    from repro_torch.models import lm
    from repro_torch.models.layers import dtype_of

    L, stages, n_micro, Bm, S = GPIPE
    cfg = _published(GPIPE_ARCH, n_layers=L)
    model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(8))
    mesh = make_mesh((stages,), ("stage",), [device] * stages)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(Bm, S)

    def stage_fn(layers, x):
        aux = torch.zeros((), dtype=torch.float32, device=device)
        for layer in layers:
            x, aux, _ = layer(x, aux, pos, cfg, True)
        return x

    x = (torch.randn((n_micro, Bm, S, cfg.d_model), generator=torch.Generator(device=device).manual_seed(9),
                     device=device)).to(dtype_of(cfg.compute_dtype))
    run = gpipe(mesh, "stage", stage_fn, n_micro)
    with torch.no_grad():
        t0 = time.perf_counter()
        got = run(stack_stage_params(list(model.layers), stages), x)
        torch.cuda.synchronize(device)
        t_pipe = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = torch.stack([stage_fn(list(model.layers), x[i]) for i in range(n_micro)])
        torch.cuda.synchronize(device)
        t_seq = time.perf_counter() - t0
    out = {"arch": GPIPE_ARCH, "layers": L, "stages": stages, "micro": n_micro, "micro_shape": [Bm, S],
           "d_model": cfg.d_model, "weights_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
           "bit_equal": bool(torch.equal(got, want)), "max_abs": _max_err(got, want), "steps": run.steps,
           "gpipe_s": t_pipe, "sequential_s": t_seq}
    del model, x, got, want
    torch.cuda.empty_cache()
    if not (out["bit_equal"] and out["steps"] == n_micro + stages - 1):
        raise AssertionError(f"gpipe ≢ the sequential layers: {out}")
    return out


def compression_check(device) -> dict:
    """``compressed_psum`` over ``COMPRESS_SLOTS`` data slots, each with its
    own N(0, 1) gradient shaped as one Phi-4-mini layer's leaves, for
    ``COMPRESS_STEPS`` steps with error feedback: at the last step, fed
    the same gradients and the card's incoming residuals, the CPU's
    reduced gradients and residuals ≡ the card's bit for bit (quantise,
    dequantise, the residual carried in and out, and the mesh-order sum;
    one step exercises all of them, and the CPU copy is the phase's
    slowest part), every slot's reduced gradient is the same at every
    step, and over the steps the feedback telescopes on the card:
    Σ_t reduced_t + mean_s r_s ≈ mean_s Σ_t g_s (tests/test_optim.py's
    bound)."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim.compression import compressed_psum

    cfg = _published("phi4-mini-3.8b", n_layers=1)
    layer = lm.abstract_params(cfg).layers[0]
    shapes = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    values = sum(int(np.prod(s)) for s in shapes.values())
    cpu = torch.device("cpu")
    meshes = {"card": make_mesh((COMPRESS_SLOTS,), ("data",), [device] * COMPRESS_SLOTS),
              "cpu": make_mesh((COMPRESS_SLOTS,), ("data",), [cpu] * COMPRESS_SLOTS)}
    res = [{n: torch.zeros(s, device=device) for n, s in shapes.items()} for _ in range(COMPRESS_SLOTS)]
    total_g = {n: torch.zeros(s, device=device) for n, s in shapes.items()}
    total_red = {n: torch.zeros(s, device=device) for n, s in shapes.items()}
    same, agree, walls = True, True, []
    for step in range(COMPRESS_STEPS):
        grads = [{n: torch.randn(s, generator=torch.Generator(device=device).manual_seed(1000 * step + 100 * i + j),
                                 device=device) for j, (n, s) in enumerate(shapes.items())}
                 for i in range(COMPRESS_SLOTS)]
        last = step == COMPRESS_STEPS - 1
        res_in = [{n: r[n].cpu() for n in shapes} for r in res] if last else None
        t0 = time.perf_counter()
        red, res = compressed_psum(grads, meshes["card"], "data", res)
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        if last:
            red_c, res_c = compressed_psum([{n: g.cpu() for n, g in gs.items()} for gs in grads], meshes["cpu"],
                                           "data", res_in)
            same &= all(torch.equal(red[0][n].cpu(), red_c[0][n]) for n in shapes)
            same &= all(torch.equal(r[n].cpu(), rc[n]) for r, rc in zip(res, res_c) for n in shapes)
            del red_c, res_c, res_in
        agree &= all(torch.equal(red[i][n], red[0][n]) for i in range(COMPRESS_SLOTS) for n in shapes)
        for n in shapes:
            total_g[n] += sum(g[n] for g in grads) / COMPRESS_SLOTS
            total_red[n] += red[0][n]
        del grads, red
    worst = 0.0
    for n in shapes:
        lhs = total_red[n] + sum(r[n] for r in res) / COMPRESS_SLOTS
        worst = max(worst, float(((lhs - total_g[n]).abs() - COMPRESS_RTOL * total_g[n].abs()).max()))
    out = {"slots": COMPRESS_SLOTS, "steps": COMPRESS_STEPS, "values_a_slot": values, "leaves": len(shapes),
           "card_equals_cpu_last_step": bool(same),
           "slots_agree": bool(agree), "telescope_excess_over_rtol": worst, "atol": COMPRESS_ATOL,
           "residual_abs_max": max(float(r[n].abs().max()) for r in res for n in shapes),
           "step_s": walls}
    del res, total_g, total_red
    torch.cuda.empty_cache()
    if not (same and agree and worst <= COMPRESS_ATOL):
        raise AssertionError(f"compressed_psum: {out}")
    return out


SELFTEST_K1_SLOTS = (5, 6)  # K1 at (2, 4) slot 5 (own cells at 10) and (2, 2, 2) slot 6 (pod 1)


def selftest_kernels(device, kept: dict) -> dict:
    """Every kernel of the NOMAD selftest (``launch/selftest.py``) against
    its plain version on the selftest's own inputs (``kept``, from
    ``run(keep=True)``); a disagreement is fatal. The selftest's own
    asserts would not catch a wrong kernel: part 1 lets NP@10 fall to half
    the local fit's, and part 4 compares two fits that both run K2.

    * every kernel on the (2, 4) fit's data (:func:`check_path_kernels`:
      its index, θ, frozen map and the selftest's rows as the queries);
    * K1 at the step inputs of (2, 4) slot ``SELFTEST_K1_SLOTS[0]`` and of
      (2, 2, 2) slot ``SELFTEST_K1_SLOTS[1]`` (:func:`check_sharded_k1`);
    * K2 at every call of part 4's ``kmeans_fit_sharded``: run again with
      K2's arguments recorded (its centroids must equal the selftest's
      bit for bit), each row block against that pass's centroids."""
    import torch

    from repro_torch.core.strategy import HierarchicalStrategy, ShardedStrategy
    from repro_torch.index import kmeans
    from repro_torch.kernels.kmeans_assign import ops as k2
    from repro_torch.serve import FrozenMap, MapServer

    cfg, x, fit = kept["cfg"], kept["x"], kept["dist"]
    frozen = FrozenMap.from_fit(fit, cfg, device=device)
    xd = torch.from_numpy(x).to(device)
    placed = MapServer(frozen).transform(x, seed=7).embedding
    out = {"path": check_path_kernels(device, fit, frozen, xd, xd, placed, random=False)}
    out["k1_slots"] = {
        "(2, 4)": check_sharded_k1(device, cfg, fit, ShardedStrategy(
            mesh=kept["mesh"], shard_axes=("data", "model")), SELFTEST_K1_SLOTS[0]),
        "(2, 2, 2)": check_sharded_k1(device, cfg, kept["hier"], HierarchicalStrategy(
            mesh=kept["mesh3"], shard_axes=("data", "model"), pod_axis="pod"), SELFTEST_K1_SLOTS[1])}

    seen, real = [], kmeans.assign_nearest

    def record(a, c):
        seen.append((a, c))
        return real(a, c)

    kmeans.assign_nearest = record
    try:
        again = kmeans.kmeans_fit_sharded(torch.Generator(device=device).manual_seed(0), kept["blocks"],
                                          cfg.n_clusters, kept["mesh1"], n_iters=5)
    finally:
        kmeans.assign_nearest = real
    if not torch.equal(again, kept["cents_d"]):
        raise AssertionError("part 4's kmeans_fit_sharded, run again, gave other centroids")
    rows = []
    for a, c in seen:
        got, want = k2.assign_nearest_cuda(a, c), k2.assign_nearest_plain(a, c)
        torch.cuda.synchronize()
        rows.append(k2_check_scaled(a, c, got, want))  # raises on disagreement
    out["kmeans_fit_sharded"] = {"calls": len(rows), "shape": rows[0]["shape"],
                                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                                 "argmin_equal_frac_min": min(r["argmin_equal_frac"] for r in rows)}
    del xd
    return out


def lm_sharded_path(device) -> dict:
    """The LM side of multi-GPU on shard slots of one card: ``moe_ep``
    (:func:`ep_check`), the length-sharded decode
    (:func:`decode_sharded_check`), GPipe (:func:`gpipe_check`), the
    compressed all-reduce (:func:`compression_check`), then the port's two
    selftests on the card's slots, their K1–K3 launches counted (the
    kernels line's ``selftest`` column), and every kernel the NOMAD
    selftest ran held to its plain version on that selftest's own inputs
    (:func:`selftest_kernels`)."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.launch import selftest, selftest_pipeline

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the fp32 checks would not be fp32")
    t_phase, walls = time.perf_counter(), {}
    out = {"reduced": LM_SHARDED_REDUCED, "walls_s": walls}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        walls[label] = time.perf_counter() - t0
        return r

    out["ep"], mixtral, mixtral_cfg = timed("ep", ep_check, device)
    out["decode"] = timed("decode", decode_sharded_check, device, mixtral, mixtral_cfg)
    del mixtral
    torch.cuda.empty_cache()
    out["gpipe"] = timed("gpipe", gpipe_check, device)
    out["compression"] = timed("compression", compression_check, device)
    registry.reset_launch_counts()
    out["selftest"] = timed("selftest", lambda: selftest.run(device, keep=True))
    out["selftest_pipeline"] = timed("selftest_pipeline", selftest_pipeline.run, device)
    out["launches"] = registry.launch_counts()
    missing = [n for n in FIT_KERNELS if out["launches"][n] == 0]
    if missing:
        raise AssertionError(f"the selftests never launched {missing}")
    out["selftest_kernels"] = timed("selftest_kernels", selftest_kernels, device, out["selftest"].pop("kept"))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


AUTOTUNE_KERNELS = ("kmeans_assign", "pairwise")  # the only specs with more than one plan
AUTOTUNE_MAIN = {"kmeans_assign": [((16384, 768), (4096, 768)), ((1024, 768), (4096, 768))],
                 "pairwise": [((16384, 768), (4096, 768)), ((256, 305, 768), (256, 305, 768))]}


def autotune_check(device) -> dict:
    """The registry's specs and the autotuner on the card: K2 and K3's every
    plan ≡ the default plan bit for bit at each ``check_shapes`` entry, and
    a sweep at the main path's shapes (winners and times; every candidate
    bit-equal); every spec's ``validate`` at its check shapes (the
    plain-only ``capacity_admit`` refuses); a round trip of the cache in a
    temporary directory (recorded → a fresh process's winner, which K3's
    wrapper, called without a plan, then runs, bit-equal to the default
    tile; a corrupt file → a fresh sweep, rewritten). None of it is counted
    as a launch."""
    import tempfile

    import torch

    from repro_torch.kernels import autotune, registry
    from repro_torch.kernels.pairwise import ops as k3

    t_phase = time.perf_counter()
    registry.reset_launch_counts()
    out = {"plans": {}, "sweeps": {}, "validated": {}}
    for name in AUTOTUNE_KERNELS:
        sp = registry.spec(name)
        rows = []
        for i, sig in enumerate(sp.check_shapes):
            args = sp.make_inputs(_gen(device, 40 + i), sig)
            with registry.uncounted():
                want = sp.cuda(*args, plan=sp.default_plan(sig, device))
                plans = sp.plan_candidates(sig)
                same = {str(p): all(torch.equal(a, b) for a, b in zip(registry.output_leaves(sp.cuda(*args, plan=p)),
                                                                       registry.output_leaves(want))) for p in plans}
            rows.append({"sig": sig, "default": sp.default_plan(sig, device), "bit_equal": same})
            if not all(same.values()):
                raise AssertionError(f"{name}: a plan changes the output at {sig}: {same}")
        out["plans"][name] = rows
        for shapes in AUTOTUNE_MAIN[name]:
            sig = tuple((s, "float32") for s in shapes)
            entry = autotune.sweep(sp, sig, device=device, report=True)
            out["sweeps"][f"{name} {shapes}"] = {"winner": entry["plan"], "us": entry["us"],
                                                 "default": sp.default_plan(sig, device),
                                                 "candidates": entry["candidates"]}
            print(json.dumps({"autotune": name, "shapes": shapes, "winner": entry["plan"], "us": entry["us"],
                              "candidates": entry["candidates"]}), flush=True)
            if not all(c["bit_equal"] for c in entry["candidates"]) or entry["us"] is None:
                raise AssertionError(f"{name} at {shapes}: {entry}")
    for name in registry.spec_names():
        sp = registry.spec(name)
        if sp.cuda is None:
            args = sp.make_inputs(_gen(device, 0), sp.check_shapes[0])
            try:
                registry.validate(name, args)
            except ValueError:
                out["validated"][name] = "refused (plain-only)"
                continue
            raise AssertionError(f"validate ran the plain-only {name}")
        for i, sig in enumerate(sp.check_shapes):
            registry.validate(name, sp.make_inputs(_gen(device, 60 + i), sig))
        out["validated"][name] = len(sp.check_shapes)
    env = {k: os.environ.get(k) for k in ("REPRO_TUNE_CACHE", "REPRO_AUTOTUNE")}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            path = os.path.join(tmp, "tune.json")
            os.environ["REPRO_TUNE_CACHE"], os.environ["REPRO_AUTOTUNE"] = path, "0"
            sp = registry.spec("pairwise")
            sig = ((((49_000, 64), "float32"), ((256, 64), "float32")))
            planted = {"plan": {"tile": 64}, "us": 1.0}
            autotune.clear_memory_cache()
            autotune.record(sp, sig, planted, device=device)
            autotune.clear_memory_cache()
            same_bucket = (((50_000, 64), "float32"), ((256, 64), "float32"))
            reloaded = autotune.plan_for(sp, same_bucket, device=device)
            # K3's wrapper, called without a plan, takes the planted tile (64, not tile_for's 128)
            taken, real_plan_for = [], autotune.plan_for

            def spy(*a, **kw):
                taken.append(real_plan_for(*a, **kw))
                return taken[-1]

            g = _gen(device, 80)
            xs, ys = (torch.randn(s, generator=g, device=device) for s, _ in same_bucket)
            autotune.plan_for = spy
            try:
                with registry.uncounted():
                    by_cache = k3.pairwise_dist2_cuda(xs, ys)
                    by_default = k3.pairwise_dist2_cuda(xs, ys, plan=sp.default_plan(same_bucket, device))
            finally:
                autotune.plan_for = real_plan_for
            wrapper = {"took": taken, "default": sp.default_plan(same_bucket, device),
                       "bit_equal_to_default": bool(torch.equal(by_cache, by_default))}
            del xs, ys, by_cache, by_default
            with open(path, "w") as f:
                f.write("{definitely not json")
            os.environ["REPRO_AUTOTUNE"] = "1"
            autotune.clear_memory_cache()
            swept = autotune.plan_for(sp, sp.check_shapes[0], device=device)
            with open(path) as f:
                blob = json.load(f)
            key = autotune.cache_key(sp.name, autotune.card_name(device), sp.check_shapes[0])
            out["cache_roundtrip"] = {"reloaded": reloaded, "swept": swept, "version": blob.get("version"),
                                      "rewritten": blob.get("entries", {}).get(key, {}).get("plan") == swept,
                                      "wrapper": wrapper}
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            autotune.clear_memory_cache()
    rt = out["cache_roundtrip"]
    if not (rt["reloaded"] == planted["plan"] and rt["rewritten"] and rt["version"] == autotune.CACHE_VERSION
            and rt["wrapper"]["took"] == [planted["plan"]] and rt["wrapper"]["bit_equal_to_default"]):
        raise AssertionError(f"the autotune cache's round trip: {out['cache_roundtrip']}")
    out["launches"] = registry.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"sweeps and validate counted launches: {out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def dryrun_check(train: dict, decode: dict) -> dict:
    """The dry run (``repro_torch.launch.dryrun.run_lm_cell``, on meta
    tensors) of the train phase's own Phi-4-mini cell (``TRAIN_REDUCED``)
    and of the decode phase's Phi-4-mini step: the predicted memory beside
    the measured peaks (reported: the caching allocator rounds up) and the
    op counter's matrix-product FLOPs beside ``train_flops``' hardware
    count, within ``DRYRUN_FLOP_REL`` (the gate: two counts of the same
    products)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import run_lm_cell

    t0 = time.perf_counter()
    phi = train["phi4_mini"]
    tcfg = dataclasses.replace(pipeline_arch(), remat="full", attn_impl="flash")
    tshape = ShapeConfig("train_4k_reduced", "train", TRAIN_SEQ, TRAIN_ACCUM * TRAIN_MICRO)
    rec = run_lm_cell(tcfg, tshape)
    flop_rel = rec["op_cost"]["dot_flops"] / phi["hardware_flops"] - 1.0
    out = {"train": {"cell": [TRAIN_ACCUM * TRAIN_MICRO, TRAIN_SEQ, TRAIN_ACCUM], "trace_s": rec["trace_s"],
                     "memory": rec["memory"], "measured_peak_bytes": phi["peak_device_gb"] * 1e9,
                     "memory_ratio": rec["memory"]["per_device_total"] / (phi["peak_device_gb"] * 1e9),
                     "dot_flops": rec["op_cost"]["dot_flops"], "dot_by_op": rec["op_cost"]["dot_by_op"],
                     "train_flops_hardware": phi["hardware_flops"], "flop_rel": flop_rel,
                     "op_flops": rec["op_cost"]["flops"], "op_bytes": rec["op_cost"]["bytes"],
                     "terms": rec["terms"], "model_flops": rec["model_flops"],
                     "measured_step_ms_p50": phi["step_ms_p50"]}}
    print(json.dumps({"dryrun_train": out["train"]}), flush=True)
    if not abs(flop_rel) <= DRYRUN_FLOP_REL:
        raise AssertionError(f"the dry run counts {rec['op_cost']['dot_flops']:.6e} matrix-product FLOPs, "
                             f"train_flops {phi['hardware_flops']:.6e} ({flop_rel:+.2%})")
    dphi = decode["phi4_mini"]
    dshape = ShapeConfig("decode_reduced", "decode", dphi["cache_capacity"], dphi["batch"])
    drec = run_lm_cell(pipeline_arch(), dshape)
    out["decode"] = {"cell": [dphi["batch"], dphi["cache_capacity"]], "trace_s": drec["trace_s"],
                     "memory": drec["memory"], "measured_peak_bytes_with_prefill": dphi["peak_device_gb"] * 1e9,
                     "dot_flops": drec["op_cost"]["dot_flops"], "op_bytes": drec["op_cost"]["bytes"],
                     "memory_bound_ms": drec["terms"]["memory_s"] * 1e3, "terms": drec["terms"],
                     "model_flops": drec["model_flops"], "measured_step_ms_p50": dphi["step_ms_p50"],
                     "measured_step_bound_ms": dphi["step_bound_ms"]}
    print(json.dumps({"dryrun_decode": out["decode"]}), flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 11: the stream path (fit and serve from an on-disk store)
# ---------------------------------------------------------------------------

STREAM_CHUNK = 65_536  # cfg.chunk_rows: 16 chunks at N = 1M, the last 16,960 rows
STREAM_SHARD = 65_536  # rows a shard of the bf16 store
STREAM_Q = 4096  # queries served on the streamed map from an .npy
RANDOMIZED_PCA = (65_536, 4096)  # N, D of the randomized PCA check (D > 2048)
STREAM_REDUCED = REDUCED + [
    "the store holds the main path's rows rounded to bfloat16 (1.54 GB on disk)",
]
# a tiny image the children are started from: a child forked straight from
# this multi-GB process would inherit its RSS as the start of ru_maxrss
INTERPOSE = "import subprocess, sys; sys.exit(subprocess.run(sys.argv[1:]).returncode)"


def stream_config():
    """The main path's config, fitted from the store in 65,536-row chunks
    with a bf16 x_rows spill (lossless for bf16-exact rows)."""
    return main_config().replace(chunk_rows=STREAM_CHUNK, store_dtype="bfloat16")


def stream_child(mode: str, work: str, device: str, cfg_json: str) -> int:
    """One fit in a process of its own, so its ru_maxrss is its own:
    ``stream`` fits the store directory under ``work`` itself, ``resident``
    fits the same rows materialised in RAM (chunk_rows 0), both with the
    config ``cfg_json`` on ``device``. Writes ``<mode>.json`` (and, for
    ``stream``, the embedding and the store-query checks) under ``work``."""
    import torch

    from repro_torch.configs import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.store import ShardedStore
    from repro_torch.index.build import rss_mb
    from repro_torch.kernels import registry

    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = NomadConfig(**json.loads(cfg_json))
    store_dir = os.path.join(work, "store")
    src = store_dir if mode == "stream" else ShardedStore(store_dir).materialize()
    if mode != "stream":
        cfg = cfg.replace(chunk_rows=0)
    if on_card:
        torch.cuda.init()  # a fresh process: the allocator's statistics need the context
        torch.cuda.reset_peak_memory_stats(device)
        torch.ones(1, device=device).sum().item()  # the context's host memory, before the fit
    rss_before = rss_mb()
    est = NomadProjection(cfg, device=device)
    registry.reset_launch_counts()
    t0 = time.time()
    res = est.fit(src)
    wall = time.time() - t0
    launches = registry.launch_counts()
    out = {
        "mode": mode, "build": res.index_build_strategy, "wall_s": wall, "stage_s": res.stage_s,
        "stage_rss_mb": res.stage_rss_mb, "peak_rss_mb": rss_mb(), "rss_before_fit_mb": rss_before,
        "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
        "losses": res.losses, "launches": launches, "stragglers": res.index_build_stragglers,
        "x_rows": type(res.index.x_rows).__name__,
    }
    if mode == "stream":
        np.save(os.path.join(work, "stream_emb.npy"), res.embedding)
        out["pass_probe"] = pass_probe(ShardedStore(store_dir), cfg.chunk_rows, device)
        # serving on the streamed map: the same queries as an array, an
        # .npy memmap and the .npy's path, bit for bit
        path = os.path.join(work, "q.npy")
        server = est.map_server()
        t1 = time.time()
        want = server.transform(np.load(path), seed=0)
        out["serve_array_s"] = time.time() - t1
        for label, q in (("memmap", np.load(path, mmap_mode="r")), ("path", path)):
            got = server.transform(q, seed=0)
            out[f"serve_{label}_equal"] = all(
                np.array_equal(getattr(got, f), getattr(want, f))
                for f in ("embedding", "cells", "neighbor_ids", "neighbor_dists"))
        out["serve_finite"] = bool(np.isfinite(want.embedding).all())
    with open(os.path.join(work, f"{mode}.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


def pass_probe(store, chunk_rows: int, device) -> dict:
    """Seconds of one pass over the store, each way of reading it: loading
    the shard files alone (``load_s``); reading and decoding the chunks on
    the host (``read_s``); that and uploading the float32 chunks
    (``host_decode_to_device_s``); and the way the streamed stages read,
    the stored bf16 bits uploaded and widened on the card
    (``to_device_s``, :func:`repro_torch.index.kmeans.device_chunks`)."""
    import torch

    from repro_torch.data.store import stream_chunks
    from repro_torch.index.kmeans import device_chunks

    def timed(items):
        t0 = time.time()
        for _ in items:
            pass
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.time() - t0

    return {
        "load_s": timed(np.load(os.path.join(store.path, f)) for f in store._files),
        "read_s": timed(stream_chunks(store, chunk_rows)),
        "host_decode_to_device_s": timed(torch.from_numpy(c).to(device) for _s, c in stream_chunks(store, chunk_rows)),
        "to_device_s": timed(device_chunks(store, chunk_rows, device)),
        "chunks": -(-store.shape[0] // chunk_rows),
    }


def run_child(mode: str, work: str, device, cfg) -> dict:
    """Run :func:`stream_child` in a fresh process; its failure fails the run."""
    import dataclasses

    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-c", INTERPOSE, sys.executable, os.path.abspath(__file__), "--child", mode, work,
         str(device), json.dumps(dataclasses.asdict(cfg))],
        capture_output=True, text=True, timeout=900,
    )
    if r.returncode != 0:
        raise AssertionError(f"the {mode} child failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    with open(os.path.join(work, f"{mode}.json")) as f:
        out = json.load(f)
    out["process_s"] = time.time() - t0
    return out


def randomized_pca(device):
    """``pca_init`` and ``pca_init_streamed`` at D 4096 (> 2048: the
    range-finder) on the card against the port's CPU result, within 1e-4
    of the largest |θ| after aligning each column's sign, on rows whose top
    two variances stand far above the rest."""
    import torch

    from repro_torch.core.pca import pca_init, pca_init_streamed
    from repro_torch.data.store import ArrayStore

    n, d = RANDOMIZED_PCA
    rng = np.random.default_rng(3)
    basis = np.linalg.qr(rng.normal(size=(d, 2)))[0].T
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= 0.1
    x += (rng.normal(size=(n, 2)) * np.array([6.0, 3.0]) @ basis + 0.5).astype(np.float32)
    out = {"n": n, "d": d}
    for label, run in (
        ("resident", lambda dev: pca_init(torch.from_numpy(x).to(dev)).cpu().numpy()),
        ("streamed", lambda dev: pca_init_streamed(ArrayStore(x), chunk_rows=8192, device=dev)),
    ):
        t0 = time.time()
        card = run(device)
        card_s = time.time() - t0
        cpu = run(torch.device("cpu"))
        card = card * np.where(np.sum(card * cpu, 0) < 0, -1.0, 1.0)
        scale = float(np.abs(cpu).max())
        err = float(np.abs(card - cpu).max())
        if not err <= 1e-4 * scale:
            raise AssertionError(f"randomized PCA ({label}) on the card vs the CPU: {err} > 1e-4 × {scale}")
        out[label] = {"max_abs_diff": err, "scale": scale, "card_s": card_s}
    return out


def stream_path(device, x):
    """Write the main path's rows as a bf16 sharded store under
    chiprun_out/, fit it streamed in a child process (launch counts, stage
    times and RSS, store queries ≡ array queries), fit the same rows
    resident in another child for its RSS, and here fit the materialised
    rows with the same chunk_rows: bit-equal to the store's fit. Then the
    randomized PCA check. The store and its spill are deleted at the end."""
    import shutil

    import torch

    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.store import write_sharded

    cfg = stream_config()
    work = os.path.join(OUT_DIR, "stream")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.time()
        store = write_sharded(x, os.path.join(work, "store"), rows_per_shard=STREAM_SHARD, dtype="bfloat16")
        write_s = time.time() - t0
        np.save(os.path.join(work, "q.npy"), mixture_queries(STREAM_Q, cfg.dim, MAIN_COMPONENTS, seed=2))
        stream = run_child("stream", work, device, cfg)
        resident = run_child("resident", work, device, cfg)
        emb = np.load(os.path.join(work, "stream_emb.npy"))

        rows = store.materialize()
        t0 = time.time()
        same = NomadProjection(cfg, device=device).fit(rows)
        same_s = time.time() - t0
        if not (np.array_equal(same.embedding, emb) and same.losses == stream["losses"]):
            bad = int(np.sum(np.any(same.embedding != emb, axis=1)))
            raise AssertionError(f"fit(store) differs from fit(store.materialize()) at chunk_rows "
                                 f"{STREAM_CHUNK}: {bad} rows, losses {stream['losses']} vs {same.losses}")
        if not (emb.shape == (MAIN_N, cfg.out_dim) and np.isfinite(emb).all()):
            raise AssertionError(f"streamed embedding not finite of shape {(MAIN_N, cfg.out_dim)}")
        if not stream["losses"][-1] < stream["losses"][0]:
            raise AssertionError(f"streamed fit's loss did not fall: {stream['losses']}")
        missing = [n for n in FIT_KERNELS if stream["launches"][n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the stream path: {missing}")
        if stream["build"] != "streamed" or stream["x_rows"] != "ShardedStore":
            raise AssertionError(f"the store's fit took the {stream['build']} build ({stream['x_rows']} x_rows)")
        if not (stream["serve_memmap_equal"] and stream["serve_path_equal"] and stream["serve_finite"]):
            raise AssertionError("store queries differ from array queries on the streamed map")
        if not stream["peak_rss_mb"] < resident["peak_rss_mb"]:
            raise AssertionError(f"streamed fit's peak RSS {stream['peak_rss_mb']} MB is not below the "
                                 f"resident fit's {resident['peak_rss_mb']} MB")
        quality = embedding_quality(rows, emb, device)
        del rows, same
        if device.type == "cuda":
            torch.cuda.empty_cache()
        pca = randomized_pca(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {
        "config": {"chunk_rows": cfg.chunk_rows, "store_dtype": cfg.store_dtype, "rows_per_shard": STREAM_SHARD,
                   "n_points": cfg.n_points, "n_epochs": cfg.n_epochs},
        "reduced": STREAM_REDUCED,
        "store_write_s": write_s,
        "stream": stream,
        "resident": {k: resident[k] for k in ("wall_s", "stage_s", "stage_rss_mb", "peak_rss_mb",
                                               "rss_before_fit_mb", "peak_device_gb", "process_s", "build")},
        "bit_equal_fit_s": same_s,
        "fit_store_equals_fit_array": True,
        "store_queries": STREAM_Q,
        "store_queries_equal_array": True,
        "rss_below_resident": True,
        "quality": quality,
        "randomized_pca": pca,
    }


# ---------------------------------------------------------------------------


# the JAX spec's, then K past 4096 as a map grown by partial_fit has it
CAUCHY_SHAPES = [(512, 1024, 2), (100, 64, 2), (64, 100, 3), (777, 333, 2), (1024, 4133, 2)]
CAUCHY_SERVE = (1024, 4096, 2)  # serve_microbatch queries against K means
ATTRACT_SHAPES = [(512, 15, 2), (64, 8, 2), (100, 5, 3), (777, 15, 2)]  # the JAX spec's
ATTRACT_SERVE = (1024, 15, 2)
ATTRACT_WIDE = (64, 40, 4)  # k past a warp's 32 lanes: two neighbours a lane
NOMAD_SHAPES = [(512, 15, 16, 64, 2), (100, 5, 4, 33, 2), (64, 3, 8, 100, 3), (777, 15, 16, 130, 2),
                (1024, 15, 16, 4133, 2)]  # the JAX spec's, then the 3-chunk plan of a grown map
NOMAD_MAIN = (8192, 15, 16, 4096, 2)
# the JAX spec's, then a split's k-means: one cell's ~321 members against
# n_sub = 2 or 3 sub-cell centroids at D 768
KMEANS_SHAPES = [(512, 256, 64), (1000, 17, 32), (64, 512, 128), (513, 255, 48), (321, 2, 768), (321, 3, 768)]
KMEANS_MAIN = (16384, 4096, 768)
KMEANS_SERVE = (1024, 4096, 768)  # one serve_microbatch of queries against K centroids
# the JAX spec's, then a split's candidate pass (members × n_sub at D 768)
PAIRWISE_SHAPES = [(96, 128, 64), (100, 60, 33), (8, 257, 128), (64, 64, 16), (321, 2, 768), (321, 3, 768)]
PAIRWISE_CAND = (16384, 4096, 768)
PAIRWISE_CELL = (256, 305, 305, 768)  # 256 cells of capacity 305 against themselves
PAIRWISE_QUERY = (256, 1, 305, 768)  # serving: a block of 256 queries, each against its cell
# the top-k sites' (distances, k) at the main path's shapes: the candidate
# pass's row block against K, 256 cells of 305 against themselves, serving's
# block of 256 queries against their cells
TOP_K_SITES = {"candidates": ((16384, 4096), 32), "in_cell": ((256, 305, 305), 15),
               "query": ((256, 305), 15)}

TPU_KERNELS = [
    ("K1f nomad_step_fwd", "src/repro/kernels/nomad_step/nomad_step.py:166", "nomad_step_fwd"),
    ("K1b nomad_step_bwd", "src/repro/kernels/nomad_step/nomad_step.py:201", "nomad_step_bwd"),
    ("K2 kmeans_assign", "src/repro/kernels/kmeans_assign/kmeans_assign.py:53", "kmeans_assign"),
    ("K3 pairwise", "src/repro/kernels/pairwise/pairwise.py:59", "pairwise"),
    ("K4f cauchy_mean_fwd", "src/repro/kernels/cauchy_mean/cauchy_mean.py:83", "cauchy_mean_fwd"),
    ("K4b cauchy_mean_bwd", "src/repro/kernels/cauchy_mean/cauchy_mean.py:104", "cauchy_mean_bwd"),
    ("K5f frozen_attract_fwd", "src/repro/kernels/frozen_attract/frozen_attract.py:71", "frozen_attract_fwd"),
    ("K5b frozen_attract_bwd", "src/repro/kernels/frozen_attract/frozen_attract.py:92", "frozen_attract_bwd"),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_entries(log: str) -> list:
    """Each kernel of a ``ptxas -v`` log: its mangled name, registers and
    spill bytes."""
    import re

    entries, props = [], {}
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entries.append({"entry": m.group(1)})
        elif m := re.search(r"Function properties for (\S+)", line):
            props = {"entry": m.group(1)}
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            for e in entries:
                if e["entry"] == props.get("entry"):
                    e["spill_stores"], e["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and entries:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def kernel_phases(device):
    """Phases 2 and 3: build every kernel, then check and time each one."""
    from repro_torch.kernels import _build

    t0 = time.time()
    libs = _build.build()
    build_s = time.time() - t0
    ptxas = {n: [ln.strip() for ln in _build.ptxas_report(n).splitlines() if "Used" in ln or "spill" in ln]
             for n in libs}
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}), flush=True)
    # registers and spills: K1's main-path instantiations (d = 2), every K5
    # instantiation (d = 1-4) and K4's at d = 1 and 4
    k1 = [e for e in ptxas_entries(_build.ptxas_report("nomad_step")) if "ILi2E" in e["entry"]]
    k5 = ptxas_entries(_build.ptxas_report("frozen_attract"))
    k4 = [e for e in ptxas_entries(_build.ptxas_report("cauchy_mean")) if "ILi1E" in e["entry"] or "ILi4E" in e["entry"]]
    print(json.dumps({"ptxas_nomad_step_d2": k1, "ptxas_frozen_attract": k5, "ptxas_cauchy_mean_d1_d4": k4}),
          flush=True)
    spilled = [e["entry"] for e in k5 if e.get("spill_stores") or e.get("spill_loads")]
    if len(k5) != 8 or spilled:
        raise AssertionError(f"frozen_attract: {len(k5)} of 8 instantiations in ptxas's log, spills in {spilled}")
    # a process's first profiler session can come back without a single
    # kernel (K1f's device time then reads 0), so a throwaway one runs first
    import torch

    device_ms(lambda: torch.ones(1, device=device).add_(1), reps=1)
    checks, timing = {}, {}
    for name, fn, args in (
        ("nomad_step", check_nomad_step, (NOMAD_SHAPES, NOMAD_MAIN)),
        ("kmeans_assign", check_kmeans_assign, (KMEANS_SHAPES, KMEANS_MAIN, KMEANS_SERVE)),
        ("pairwise", check_pairwise, (PAIRWISE_SHAPES, PAIRWISE_CAND, PAIRWISE_CELL, PAIRWISE_QUERY)),
        ("cauchy_mean", check_cauchy_mean, (CAUCHY_SHAPES, CAUCHY_SERVE)),
        ("frozen_attract", check_frozen_attract, (ATTRACT_SHAPES + [ATTRACT_WIDE], ATTRACT_SERVE)),
    ):
        rows, t = fn(device, *args)
        checks[name] = rows
        timing.update(t)
        print(json.dumps({"checked": name, "rows": rows, "timing": t}), flush=True)
    checks["top_k"] = check_top_k(device, TOP_K_SITES)
    print(json.dumps({"checked": "top_k", "sites": checks["top_k"]}), flush=True)
    return build_s, checks, timing


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from repro_torch.kernels import registry  # fails before any output without src/

    device = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    card = card_line()
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    build_s, checks, timing = kernel_phases(device)

    main_res, x, est, fit = main_path(device)
    print(json.dumps({"main_path": main_res}), flush=True)
    quality = small_quality(device)
    print(json.dumps({"small_quality": quality}), flush=True)
    serve = serve_path(device, main_config(), fit, x)
    print(json.dumps({"serve_path": serve}), flush=True)
    t0 = time.time()
    partial = partial_path(device, main_config(), est, fit, x)
    partial["phase_s"] = time.time() - t0
    print(json.dumps({"partial_path": partial}), flush=True)
    t0 = time.time()
    service = service_path(device, main_config(), fit, est, x)
    service["phase_s"] = time.time() - t0
    print(json.dumps({"service_path": service}), flush=True)
    del est, fit
    torch.cuda.empty_cache()
    t0 = time.time()
    pipeline = pipeline_path(device)
    pipeline["phase_s"] = time.time() - t0
    print(json.dumps({"pipeline_path": {k: v for k, v in pipeline.items() if k in ("embed", "map", "serve", "phase_s")}},
                     default=str), flush=True)
    t0 = time.time()
    decode = decode_path(device)
    decode["phase_s"] = time.time() - t0
    print(json.dumps({"decode_path": {"phase_s": decode["phase_s"], "launches": decode["launches"]}}), flush=True)
    t0 = time.time()
    train = train_path(device)
    train["phase_s"] = time.time() - t0
    print(json.dumps({"train_path": train_summary(train)}, default=str), flush=True)
    launch = launch_path(device)
    print(json.dumps({"launch_path": launch}, default=str), flush=True)
    sharded = sharded_path(device)
    print(json.dumps({"sharded_path": {k: v for k, v in sharded.items() if k != "kernels"},
                      "card": card}, default=str), flush=True)
    lm_sharded = lm_sharded_path(device)
    print(json.dumps({"lm_sharded_path": lm_sharded, "card": card}, default=str), flush=True)
    tuned = autotune_check(device)
    print(json.dumps({"autotune_check": {k: v for k, v in tuned.items() if k != "plans"}, "card": card},
                     default=str), flush=True)
    dryrun = dryrun_check(train, decode)
    print(json.dumps({"dryrun_check": {"phase_s": dryrun["phase_s"], "flop_rel": dryrun["train"]["flop_rel"],
                                       "memory_ratio": dryrun["train"]["memory_ratio"]}}), flush=True)
    stream = stream_path(device, x)
    del x
    print(json.dumps({"stream_path": stream}), flush=True)
    ckpt = checkpoint_roundtrip(device)
    print(json.dumps({"checkpoint_roundtrip": ckpt}), flush=True)
    t0 = time.time()
    small_partial = partial_small(device)
    small_partial["phase_s"] = time.time() - t0
    print(json.dumps({"partial_small": small_partial}), flush=True)

    kernels = []
    for name in FIT_KERNELS + SERVE_KERNELS[2:]:
        k, t = registry.get(name), timing[name]
        fit_n, serve_n = main_res["launches"][name], serve["launches"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            # the count of the path that runs the kernel: the fit for K1-K3,
            # serving for K4/K5; both paths' counts beside it
            "launches": fit_n if name in FIT_KERNELS else serve_n,
            "launches_by_path": {"fit": fit_n, "serve": serve_n, "partial": partial["launches"][name],
                                 "stream": stream["stream"]["launches"][name],
                                 "service": service["launches"][name], "pipeline": pipeline["launches"][name],
                                 "decode": decode["launches"][name], "train": train["launches"][name],
                                 "launch": launch["launches"][name], "sharded": sharded["launches"][name],
                                 "selftest": lm_sharded["launches"][name]},
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "library_call": t.get("library_call"),
            # the fp32 CUDA-core bound, comparable with the earlier slices' rows
            "bound_fp32_ms": t.get("bound_fp32", t["bound"])[0],
            # the bound without the SFU term, as the earlier slices took it
            "bound_no_sfu_ms": t.get("bound_no_sfu", t["bound"])[0],
        })
        if "plan" in t:  # K4's split of the means and its launch
            kernels[-1]["plan"] = t["plan"]
        if name in ("kmeans_assign", "pairwise"):  # each timed shape: route, block tile, times
            kernels[-1]["shapes"] = {label: {f: v for f, v in tt.items() if f != "max_abs_err"}
                                     for label, tt in timing.items() if label.split("[")[0] == name}
    table = [{"kernel": label, "replaces": where, "ported": port is not None,
              "checked_on_card": port is not None
              and port.removesuffix("_fwd").removesuffix("_bwd") in checks}
             for label, where, port in TPU_KERNELS]
    record = {"card": card, "build_s": build_s, "checks": checks, "timing": timing,
              "main_path": main_res, "small_quality": quality, "serve_path": serve, "partial_path": partial,
              "service_path": service, "pipeline_path": pipeline, "decode_path": decode, "train_path": train,
              "launch_path": launch, "sharded_path": sharded, "lm_sharded_path": lm_sharded,
              "autotune_check": tuned, "dryrun_check": dryrun, "stream_path": stream,
              "checkpoint_roundtrip": ckpt, "partial_small": small_partial,
              "tpu_kernels": table, "kernels": kernels}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"tpu_kernels": table}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(stream_child(*sys.argv[2:6]))
    sys.exit(main())
