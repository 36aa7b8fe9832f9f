"""Dry run: a cell's step cost and memory on meta tensors, against the
H100's peaks, on one card or on the reference's production mesh (the
port's counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles for a TPU mesh).

For every (architecture × supported input shape) cell this script builds
the step of the cell's kind (train, prefill or decode) on the cell's
``input_specs`` (meta tensors: nothing is allocated) and runs it once under
:func:`repro_torch.roofline.op_cost.analyze_ops`, then records

* ``memory``: argument, output, temp and alias bytes and
  ``per_device_total``, with ``fits`` against the card's 80 GB (a cell
  that does not fit is reported so, not as an error);
* ``op_cost``: FLOPs, HBM bytes, matrix-product FLOPs and collective bytes
  by type (in place of the JAX package's ``hlo_cost``);
* ``model_flops`` and the roofline ``terms`` at ``HW_H100``.

``--mesh one`` prices one card (``h100x1``). ``--mesh single|multi|both``
prices the reference's production meshes: 16×16 over (``data``,
``model``), tagged ``pod16x16`` (256 cards), and 2×16×16 with ``pod``,
tagged ``pod2x16x16`` (512 cards). A mesh cell is **spec-billed**
(:func:`mesh_cost`): every argument is placed by
``launch.sharding.step_shardings`` and its per-card bytes are slot 0's
blocks of those specs (a dimension that does not split is padded up, as
XLA pads it); the step's FLOPs and HBM bytes are the one-card trace's over
the cards (an even split: work that the partitioner replicates is not
seen); its temp is the trace's peak of live storage with each tensor at
its per-card share (:func:`layout_split`); the collectives are billed from the specs, as a zero-3 × tensor ×
expert-parallel partitioner issues them (the rules are in
:func:`spec_collectives`). The prices are predictions at ``HW_H100``'s
peaks, with every mesh axis at NVLink's rate: optimistic for a 16-wide
axis, which spans two 8-card nodes.

The NOMAD workloads (``--arch nomad_pubmed`` / ``nomad_wiki60m``) report
the analytic epoch terms (``nomad_analytic_terms``) and the epoch state's
bytes (θ, kNN graph and counts at K·C rows, per card on a mesh), and on a
mesh the bytes of the means exchange (``core/distributed.py``'s
``cell_exchange``): the registry's kernels run on CUDA or CPU tensors, not
on meta, so the epoch is not traced.

Results land in ``<out>/<tag>/<arch>__<shape>.json``, one file a cell,
written as each cell ends (``--skip-existing`` resumes a sweep). It runs
on the CPU; ``--arch all`` takes many minutes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nomad_pubmed --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh one
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

TAG = "h100x1"
MESHES = {"one": [None], "single": [False], "multi": [True], "both": [False, True]}


def mesh_tag(multi_pod) -> str:
    """``h100x1`` (``multi_pod`` None), ``pod16x16`` or ``pod2x16x16``."""
    return TAG if multi_pod is None else ("pod2x16x16" if multi_pod else "pod16x16")


def production_mesh(multi_pod: bool):
    """The reference's production mesh as a grid of meta slots: the specs
    and the blocks read its shape alone."""
    import torch

    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devs=[torch.device("meta")] * n)


def _terms_record(terms) -> dict:
    return {
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "useful_ratio": terms.useful_ratio,
        "roofline_fraction": terms.roofline_fraction,
        "bound_s": terms.bound_s,
    }


def run_lm_cell(arch, shape, multi_pod=None) -> dict:
    """Dry-run one LM cell. ``arch`` is an ``ARCHS`` name or an
    :class:`~repro_torch.configs.base.ArchConfig`, ``shape`` a ``SHAPES``
    name or a :class:`~repro_torch.configs.base.ShapeConfig`; ``multi_pod``
    None prices one card, False / True the production mesh without / with
    the pod axis (:func:`mesh_cost`)."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.roofline.analysis import HW_H100, model_flops, roofline_terms
    from repro_torch.roofline.op_cost import analyze_ops, memory_analysis

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    # the reference's steps: train microbatched with its AdamW
    optimizer = AdamW(schedule=warmup_cosine(3e-4, 2000, 100_000), moment_dtype=cfg.opt_moment_dtype)
    if shape.kind == "train":
        step = steps_lib.make_train_step(cfg, optimizer, microbatched=True)
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg)
    else:
        step = steps_lib.make_decode_step(cfg)
    t0 = time.time()
    specs = steps_lib.input_specs(cfg, shape, optimizer)
    specs_s = time.time() - t0
    t0 = time.time()
    if multi_pod is None:
        out, rep = analyze_ops(step, *specs)
        memory = memory_analysis(specs, out, rep)
        n_chips, dev, extra = 1, rep, {}
    else:
        mesh = production_mesh(multi_pod)
        n_chips = mesh.size
        memory, dev, extra, rep = mesh_cost(cfg, shape, mesh, specs, step)
    trace_s = time.time() - t0
    mf = model_flops(cfg, shape)
    tag = mesh_tag(multi_pod)
    memory["fits"] = memory["per_device_total"] <= HW_H100["hbm_bytes"]
    terms = roofline_terms(dev, n_chips, mf, HW_H100)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "device": tag,
        "mesh": tag,
        "hw": HW_H100["name"],
        "n_chips": n_chips,
        "kind": shape.kind,
        "ok": True,
        "specs_s": round(specs_s, 2),
        "trace_s": round(trace_s, 2),
        "memory": memory,
        "op_cost": {
            "flops": dev.flops,
            "bytes": dev.bytes,
            "collective_bytes": dev.collective_bytes,
            "coll_by_type": dev.coll_by_type,
            "coll_ops": dev.coll_ops,
            "dot_flops": dev.dot_flops,
            "unknown_trip_whiles": dev.unknown_trip_whiles,
            "temp_bytes": dev.temp_bytes,
            "ops": rep.ops,
            "dot_by_op": {k: v / n_chips for k, v in rep.dot_by_op.items()},
        },
        **extra,
        "model_flops": mf,
        "terms": _terms_record(terms),
    }


# ---------------------------------------------------------------------------
# The production mesh: per-card blocks and the collectives of the specs
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def _spec_axes(spec) -> set:
    return {a for e in spec for a in _axes(e)}


def local_shape(shape, spec, mesh) -> tuple:
    """Slot 0's block of a global ``shape`` under ``spec``: each dimension
    over its entry's slots, rounded up (XLA pads a dimension that does not
    split); missing trailing entries are whole."""
    from repro_torch.launch.mesh import axis_size

    return tuple(-(-int(n) // axis_size(mesh, spec[d] if d < len(spec) else None)) for d, n in enumerate(shape))


def local_bytes(t, spec, mesh) -> float:
    """Bytes of slot 0's block of tensor ``t`` under ``spec``."""
    n = 1
    for d in local_shape(t.shape, spec, mesh):
        n *= d
    return float(n * t.element_size())


def placed_leaves(tree, specs) -> list:
    """``[(name, tensor, spec)]`` of ``tree`` under ``specs`` (the shape of
    ``step_shardings``' answer): an LM against ``{name: P}``, dicts by key,
    lists and tuples in order, a ``QTensor`` by field; a spec of None
    leaves a tensor whole."""
    import torch

    from repro_torch.launch.mesh import P
    from repro_torch.optim.quantized import QTensor

    out = []

    def walk(path, t, sp):
        if isinstance(t, torch.nn.Module):
            for name, p in t.named_parameters():
                out.append((name, p, P() if sp is None else sp[name]))
        elif isinstance(t, QTensor):
            walk(path + ".q", t.q, None if sp is None else sp.q)
            walk(path + ".scale", t.scale, None if sp is None else sp.scale)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(f"{path}.{k}", v, sp.get(k) if isinstance(sp, dict) else None)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(f"{path}.{i}", v, None if sp is None else sp[i])
        elif isinstance(t, torch.Tensor):
            out.append((path, t, P() if sp is None else sp))

    walk("", tree, specs)
    return out


def token_axes(cfg, shape, mesh):
    """The batch axes of the step's activations, the reference's choice:
    the data-parallel axes when a microbatch divides them, else ``data``
    when it divides that, else none (replicated)."""
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    micro = shape.global_batch // (max(cfg.accum_steps, 1) if shape.kind == "train" else 1)
    if micro % dp_size == 0:
        return dp
    if micro % mesh.shape["data"] == 0:
        return ("data",)
    return None


def _contraction_dims(name: str, ndim: int) -> tuple:
    """The dimensions a weight's product sums over: an expert weight's
    middle one (its first is the expert), the model dimension of q/k/v
    (D, H, hd), every dimension but the last otherwise (wo (H, hd, D),
    (in, out) matrices, the embedding's vocabulary rows)."""
    if "moe" in name and "shared" not in name and ndim == 3:
        return (1,)
    if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv"):
        return (0,)
    return tuple(range(ndim - 1))


def spec_collectives(cfg, shape, mesh, params, p_specs, tok_axes, *, stationary: bool = False, cache_axes=None):
    """The collectives of one step under the cell's weight specs, by the
    HLO parser's wire rule, as a zero-3 × tensor × expert-parallel
    partitioner issues them. ``tok_axes`` are the activations' batch axes;
    ``T`` below is a card's tokens a microbatch, ``A`` the microbatches of
    a train step, ``R`` the forward runs of a train step (``A``, twice with
    remat). Per weight leaf:

    * ``data`` in its spec (zero-3): an all-gather of its block without
      ``data`` per forward and per backward (train: 2·A; a serving step 1);
      train reduce-scatters its gradient A times;
    * a ``pod`` axis (pure data parallelism): train all-reduces each
      gradient block once;
    * a contraction dimension split over ``model`` (or over ``data`` where
      ``data`` is not gathered: the stationary experts): the partial
      product is all-reduced, T × out × activation bytes (× top_k for an
      expert), per forward run, and in the backward the paired column-split
      input's gradient once per microbatch (not for the embedding, whose
      input is tokens); in a train step the output head (the tied
      embedding, or the audio family's ``head``) with its vocabulary over
      ``model`` all-reduces its input gradient a microbatch and the
      cross-entropy's two fp32 statistics a forward run;
    * experts over ``model`` (expert parallelism): an all-to-all out and
      back of T × top_k × d_model per MoE layer, per forward and backward.

    A decode step whose cache length is split over ``cache_axes`` gathers
    each attention layer's partial outputs and softmax statistics over
    them (B × H × (hd + 2) fp32 a card: the length-sharded flash-decode's
    combine)."""
    from repro_torch.launch.mesh import axis_size, without
    from repro_torch.models.layers import dtype_of
    from repro_torch.roofline.op_cost import CostReport

    rep = CostReport()

    def bill(kind, nbytes, times):
        if nbytes > 0 and times > 0:
            rep.add(CostReport(collective_bytes=nbytes * times, coll_by_type={kind: nbytes * times},
                               coll_ops=float(times)))

    train = shape.kind == "train"
    A = max(cfg.accum_steps, 1) if train else 1
    per_seq = 1 if shape.kind == "decode" else shape.seq_len
    T = -(-(shape.global_batch // A) * per_seq // axis_size(mesh, tok_axes))
    act = dtype_of(cfg.compute_dtype).itemsize
    R = A * (2 if train and cfg.remat != "none" else 1)
    bwd = A if train else 0
    k = max(cfg.top_k, 1)
    for name, p, spec in placed_leaves(params, p_specs):
        leaf = name.rsplit(".", 1)[-1]
        axes = _spec_axes(spec)
        expert = "moe" in name and "shared" not in name and "router" not in name and p.dim() == 3
        gathered = "data" in axes and not (stationary and expert)
        if gathered:
            whole = local_bytes(p, without(spec, "data"), mesh)
            bill("all-gather", whole, 2 * A if train else 1)
            if train:
                bill("reduce-scatter", whole, A)
        if train and "pod" in mesh.shape:
            bill("all-reduce", local_bytes(p, spec, mesh), 1)
        if p.dim() < 2:
            continue
        split = {a for d in _contraction_dims(name, p.dim()) for a in _axes(spec[d] if d < len(spec) else None)}
        split = {a for a in split if a == "model" or (a == "data" and not gathered)}
        width = p.shape[-1] * (k if expert else 1)
        if split:
            bill("all-reduce", T * width * act, R)
            if leaf != "embed":
                bill("all-reduce", T * width * act, bwd)
        vocab_dim = {"head": -1, "embed": 0}.get(leaf) if leaf == ("head" if cfg.family == "audio" else "embed") \
            else None
        if vocab_dim is not None and train and "model" in _axes(spec[vocab_dim]):
            bill("all-reduce", T * cfg.d_model * act, bwd)
            bill("all-reduce", T * 2 * 4, R)
        if expert and leaf == "w_up" and "model" in _axes(spec[0]):
            bill("all-to-all", T * k * cfg.d_model * act, 2 * (R + bwd))
    if shape.kind == "decode" and cfg.n_heads and cache_axes and axis_size(mesh, cache_axes) > 1:
        n_attn = sum(1 for layer in range(cfg.n_layers) if cfg.layer_is_attention(layer))
        b_local = -(-shape.global_batch // axis_size(mesh, tok_axes))
        bill("all-gather", axis_size(mesh, cache_axes) * b_local * cfg.n_heads * (cfg.head_dim + 2) * 4, n_attn)
    return rep


def layout_split(cfg, shape, mesh, params, p_specs, tok_axes):
    """tensor → the cards that share it, for the one-card trace's
    temporaries (``OpCounter(split=)``), by the layout a tensor of its
    shape has under the cell's specs. An activation (its leading dimension
    a microbatch's sequences, its tokens or those times top_k, or the
    sequences times the heads; behind a layer or expert dimension, the
    second) is split over the batch axes ``tok_axes``, and also over
    ``model`` where another dimension has a width that the weights split
    over ``model`` (heads, experts, d_ff, the vocabulary, d_inner; never
    d_model: the residual stream is whole over ``model``, as the reference
    pins it). Any other tensor has a
    weight's shape (gradients, casts, the optimizer's temporaries, expert
    buffers) and is split over every axis, as zero-3 × tensor parallelism
    holds them."""
    from repro_torch.launch.mesh import axis_size

    n, m, b = mesh.size, mesh.shape["model"], axis_size(mesh, tok_axes)
    seqs = shape.global_batch // (max(cfg.accum_steps, 1) if shape.kind == "train" else 1)
    tokens = seqs * (1 if shape.kind == "decode" else shape.seq_len)
    lead = {seqs, tokens, tokens * max(cfg.top_k, 1)}
    widths = {p.shape[d] for _, p, spec in placed_leaves(params, p_specs) for d in range(min(len(spec), p.dim()))
              if "model" in _axes(spec[d])} - {cfg.d_model}
    by_heads = {seqs * h: (m if h in widths else 1) for h in (cfg.n_heads, cfg.n_kv_heads) if h}

    def split(t) -> int:
        dims = tuple(t.shape)
        if not dims:
            return 1
        if dims[0] in lead or (len(dims) > 1 and dims[1] in lead):
            return b * (m if any(d in widths for d in dims if d not in lead) else 1)
        if dims[0] in by_heads:
            return b * by_heads[dims[0]]
        return n

    return split


def mesh_cost(cfg, shape, mesh, specs, step) -> tuple:
    """(memory, per-card report, extra record fields, one-card report) of
    one LM cell on ``mesh``: ``step`` runs once on the meta ``specs`` under
    the op counter with :func:`layout_split`. Argument and output bytes
    are slot 0's blocks of ``step_shardings``' specs (the prefill's cache,
    which the step leaves unconstrained, at its activations' layout);
    alias is what the step donates (train: weights and moments; decode: the
    cache); temp is the peak of the trace's live storage at each tensor's
    per-card share, less the new outputs', as for one card. FLOPs, HBM
    bytes and matrix-product FLOPs are the trace's over the cards (an even
    split); the collectives are :func:`spec_collectives`'."""
    from repro_torch.launch.sharding import decode_axes, serving_weights_resident, step_shardings
    from repro_torch.roofline.op_cost import CostReport, OpCounter

    n = mesh.size
    in_specs, out_specs = step_shardings(cfg, shape, mesh, specs)
    tok = token_axes(cfg, shape, mesh)
    split = layout_split(cfg, shape, mesh, specs[0], in_specs[0], tok)
    counter = OpCounter(split=split)
    with counter:
        out = step(*specs)
    rep = counter.report
    argument = sum(local_bytes(t, sp, mesh) for _, t, sp in placed_leaves(specs, in_specs))
    if shape.kind == "prefill":
        logits, cache = out
        output = sum(local_bytes(t, sp, mesh) for _, t, sp in placed_leaves(logits, out_specs[0])) + sum(
            float(t.untyped_storage().nbytes()) / split(t) for _, t, _ in placed_leaves(cache, None))
    else:
        output = sum(local_bytes(t, sp, mesh) for _, t, sp in placed_leaves(out, out_specs))
    donated = {"train": (0, 1), "prefill": (), "decode": (1,)}[shape.kind]
    alias = sum(local_bytes(t, sp, mesh) for i in donated for _, t, sp in placed_leaves(specs[i], in_specs[i]))
    temp = max(counter.local_temp_bytes - (output - alias), 0.0)
    memory = {"argument_bytes": argument, "output_bytes": output, "temp_bytes": temp, "alias_bytes": alias,
              "per_device_total": argument + output + temp - alias}
    stationary = (shape.kind == "decode" and cfg.n_experts > 0 and cfg.n_experts % mesh.shape["model"] == 0)
    cache_axes = decode_axes(shape, mesh)[1] if shape.kind == "decode" else None
    coll = spec_collectives(cfg, shape, mesh, specs[0], in_specs[0], tok, stationary=stationary,
                            cache_axes=cache_axes)
    dev = CostReport(flops=rep.flops / n, bytes=rep.bytes / n, dot_flops=rep.dot_flops / n, temp_bytes=temp,
                     ops=rep.ops)
    dev.add(coll)
    extra = {
        "route": "spec-billed",
        "token_axes": list(tok) if tok else None,
        "stationary": stationary,
        "serving_weights_resident": bool(cfg.n_experts and serving_weights_resident(cfg, mesh)),
        "cache_axes": list(_axes(cache_axes)) if cache_axes else None,
        "one_card": {"flops": rep.flops, "bytes": rep.bytes, "dot_flops": rep.dot_flops,
                     "temp_bytes": rep.temp_bytes},
    }
    return memory, dev, extra, rep


def nomad_state_bytes(cfg, n_chips: int = 1) -> dict:
    """The epoch state a card holds, by array: θ (K·C, out_dim) fp32 and
    the kNN graph (K·C, k) int32 + fp32 with their rows over every card,
    the counts and cumulative counts (K,) int32 over every card, the
    global counts (K,) fp32 whole (the reference's placements; a split
    that does not divide is padded up)."""
    rows, K = cfg.n_clusters * cfg.cluster_capacity, cfg.n_clusters
    r, kl = -(-rows // n_chips), -(-K // n_chips)
    return {
        "theta": r * cfg.out_dim * 4,
        "knn_idx": r * cfg.n_neighbors * 4,
        "knn_w": r * cfg.n_neighbors * 4,
        "counts": kl * 4,
        "cum_counts": kl * 4,
        "counts_global": K * 4,
    }


def nomad_exchange(cfg, n_pods: int, hierarchical: bool, refreshes: int):
    """The means exchange of an epoch (``core/distributed.py``'s
    ``cell_exchange``), by the wire rule, from its tensors' shapes: flat,
    an all-gather of every shard's (K/n, d) means (K·d fp32 gathered a
    card) a refresh; hierarchical, the pod's (K/pods, d) means gathered and
    the size-weighted super-mean sums ((d + 1) fp32) all-reduced over the
    pods."""
    from repro_torch.roofline.op_cost import CostReport

    d, K = cfg.out_dim, cfg.n_clusters
    parts = {"all-gather": (K // n_pods if hierarchical else K) * d * 4.0}
    if hierarchical:
        parts["all-reduce"] = (d + 1) * 4.0
    return CostReport(collective_bytes=refreshes * sum(parts.values()),
                      coll_by_type={k: refreshes * v for k, v in parts.items()},
                      coll_ops=float(refreshes * len(parts)))


def run_nomad_cell(workload, multi_pod=None) -> dict:
    """The NOMAD epoch of ``workload`` (a ``NOMAD_WORKLOADS`` name or a
    :class:`~repro_torch.configs.base.NomadConfig`) on one card
    (``multi_pod`` None) or on the production mesh: the analytic terms, the
    model FLOPs, a card's epoch state and, on a mesh, the means exchange.
    Not traced: the kernels run on CUDA or CPU tensors, not on meta. On
    ``n`` cards an epoch runs ``ceil(steps / n)`` steps of ``batch_size``
    heads a card, hierarchically when ``cfg.hierarchical`` and the mesh
    has pods."""
    from repro_torch.configs import get_nomad
    from repro_torch.roofline.analysis import HW_H100, nomad_analytic_terms, nomad_model_flops

    cfg = get_nomad(workload) if isinstance(workload, str) else workload
    n_chips = 1 if multi_pod is None else (512 if multi_pod else 256)
    steps = max(1, -(-cfg.resolved_steps_per_epoch() // n_chips))
    hierarchical = bool(cfg.hierarchical and multi_pod)
    state = nomad_state_bytes(cfg, n_chips)
    if multi_pod is not None:
        state.update(lr=8, key=8)  # lr0, lr1 and the epoch key, whole
    argument = float(sum(state.values()))
    output = float(state["theta"]) + (4.0 if multi_pod is not None else 0.0)
    alias = float(state["theta"]) if multi_pod is not None else output
    total = argument + output - alias
    terms = nomad_analytic_terms(cfg, n_chips, steps, HW_H100)
    bound = max(terms.values())
    tag = mesh_tag(multi_pod)
    rec = {
        "arch": cfg.name,
        "shape": "epoch",
        "device": tag,
        "mesh": tag,
        "hw": HW_H100["name"],
        "n_chips": n_chips,
        "kind": "nomad-epoch",
        "ok": True,
        "traced": False,
        "steps_per_epoch": steps,
        "hierarchical": hierarchical,
        "rows": cfg.n_clusters * cfg.cluster_capacity,
        "memory": {"state_bytes": state, "argument_bytes": argument, "output_bytes": output, "alias_bytes": alias,
                   "per_device_total": total, "fits": total <= HW_H100["hbm_bytes"]},
        "model_flops": nomad_model_flops(cfg.n_points, cfg.batch_size * n_chips, cfg.n_neighbors,
                                         cfg.n_exact_negatives, cfg.n_clusters, steps),
        "analytic_terms": terms,
        "terms": {**terms, "dominant": max(terms, key=terms.get).removesuffix("_s"), "bound_s": bound},
    }
    if multi_pod is not None:
        refreshes = max(steps // (cfg.mean_refresh_steps or steps), 1)
        ex = nomad_exchange(cfg, 2 if multi_pod else 1, hierarchical, refreshes)
        rec["collectives"] = {"collective_bytes": ex.collective_bytes, "coll_by_type": ex.coll_by_type,
                              "coll_ops": ex.coll_ops, "refreshes": refreshes}
    return rec


def cells(arch: str, shape: str) -> list:
    """The (arch, shape) cells ``--arch``/``--shape`` name, unsupported
    shapes skipped with a line."""
    from repro_torch.configs import ARCHS, NOMAD_WORKLOADS

    arch_list = list(ARCHS) + ["nomad_pubmed", "nomad_wiki60m"] if arch == "all" else [arch]
    out = []
    for a in arch_list:
        if a in NOMAD_WORKLOADS:
            out.append((a, "epoch"))
            continue
        cfg = ARCHS[a]
        for s in cfg.supported_shapes() if shape == "all" else [shape]:
            if s not in cfg.supported_shapes():
                print(f"SKIP {a} × {s}: unsupported")
                continue
            out.append((a, s))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all", help="arch id | nomad workload | 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=list(MESHES),
                    help="one: one card; single: 16x16; multi: 2x16x16; both: the two meshes")
    ap.add_argument("--out", default=os.path.join("results", "dryrun_torch"))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import NOMAD_WORKLOADS

    results = []
    for arch, shape in cells(args.arch, args.shape):
        for mp in MESHES[args.mesh]:
            tag = mesh_tag(mp)
            out_dir = os.path.join(args.out, tag)
            os.makedirs(out_dir, exist_ok=True)
            out_path = os.path.join(out_dir, f"{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(out_path):
                print(f"SKIP (exists) {arch} × {shape} × {tag}")
                continue
            print(f"=== {arch} × {shape} × {tag} ===", flush=True)
            try:
                rec = run_nomad_cell(arch, mp) if arch in NOMAD_WORKLOADS else run_lm_cell(arch, shape, mp)
                t, m = rec["terms"], rec["memory"]
                coll = rec.get("op_cost", rec.get("collectives", {})).get("coll_by_type", {})
                print(
                    f"  ok: mem/dev {m['per_device_total'] / 2**30:.2f} GiB (fits {m['fits']}) | "
                    f"compute {t['compute_s'] * 1e3:.2f} ms, memory {t['memory_s'] * 1e3:.2f} ms, "
                    f"collective {t['collective_s'] * 1e3:.2f} ms → {t['dominant']}-bound"
                    + (f" | collectives {json.dumps({k: round(v) for k, v in coll.items()})}" if coll else ""),
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — record and continue the sweep
                rec = {"arch": arch, "shape": shape, "device": tag, "mesh": tag, "ok": False,
                       "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}
                print(f"  FAIL: {rec['error']}", flush=True)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            results.append(rec)

    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ran OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
