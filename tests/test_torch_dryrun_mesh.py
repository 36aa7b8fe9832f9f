"""The port's dry run on the production meshes against the JAX package's.

One subprocess runs the reference's ``launch/dryrun.py`` cells
(``run_lm_cell`` lowers and compiles each step with XLA on 256 or 512
forced host devices; ``run_nomad_cell`` the sharded epoch) at reduced
widths: 2 layers, d_model 256, 16 heads and 16 kv heads of 32, d_ff 512,
vocabulary 1,024, 16 experts (top 2), accum 2, Mixtral's window 512;
train at 256 tokens × 256 sequences, prefill 512 × 256, decode a cache of
512 × 32 and ``long_500k`` at batch 1. The port's ``run_lm_cell`` /
``run_nomad_cell`` price the same cells, and each pair is held to:

* argument and output bytes a card within 1% (the specs place every
  argument; the prefill's cache at its activations' layout);
* matrix-product FLOPs a card within 10% of XLA's, except in the decode
  cells, where XLA replicates work past the port's even split and may
  only count more;
* in the train and prefill cells, temp bytes a card (the activations'
  layout) and the collectives' total bytes within a factor 2 of XLA's;
* the NOMAD cell's steps and hierarchy flag equal, its analytic terms
  (with the reference's hardware table passed in) within 1e-9;
* collective bytes by type printed side by side (XLA and a zero-3 ×
  tensor-parallel partitioner choose different collectives), and > 0 in
  every sharded LM cell.

``pytest -s`` prints the side-by-side lines.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

REDUCED = dict(n_layers=2, d_model=256, n_heads=16, n_kv_heads=16, head_dim=32, d_ff=512, vocab_size=1024,
               top_k=2, accum_steps=2)
SHAPES = {"train_4k": ("train", 256, 256), "prefill_32k": ("prefill", 512, 256), "decode_32k": ("decode", 512, 32),
          "long_500k": ("decode", 512, 1)}
# (label, arch, shape, multi-pod)
LM_CELLS = [
    ("phi4_train_single", "phi4-mini-3.8b", "train_4k", False),
    ("mixtral_train_multi", "mixtral-8x7b", "train_4k", True),
    ("phi4_prefill_single", "phi4-mini-3.8b", "prefill_32k", False),
    ("phi4_decode_single", "phi4-mini-3.8b", "decode_32k", False),
    ("mixtral_decode_multi", "mixtral-8x7b", "decode_32k", True),
    ("mixtral_long_single", "mixtral-8x7b", "long_500k", False),
    ("mamba_train_single", "mamba2-2.7b", "train_4k", False),
]
NOMAD = dict(n_clusters=512, n_points=16_384, dim=32)
NOMAD_CELLS = [("nomad_single", False), ("nomad_multi", True)]


def _overrides(arch: str) -> dict:
    kw = dict(REDUCED)
    if arch == "mixtral-8x7b":
        kw.update(n_experts=16, sliding_window=512)
    return kw


REFERENCE = r"""
import json, sys
import repro.configs as C
from repro.configs.base import ShapeConfig, reduced
from repro.launch import dryrun
from repro.roofline.analysis import HW_V5E

spec = json.loads(sys.argv[1])
out = {}
for label, arch, shape, multi, kw in spec["lm"]:
    cfg = reduced(C.ARCHS[arch], **kw)
    C.get_arch = lambda name, _cfg=cfg: _cfg
    kind, seq, batch = spec["shapes"][shape]
    C.SHAPES[shape] = ShapeConfig(shape, kind, seq, batch)
    rec = dryrun.run_lm_cell(arch, shape, multi, None)
    out[label] = {"memory": rec["memory"], "hlo_cost": rec["hlo_cost"], "n_chips": rec["n_chips"],
                  "mesh": rec["mesh"]}
for label, multi in spec["nomad"]:
    cfg = C.NOMAD_WORKLOADS["nomad_pubmed"].replace(**spec["nomad_kw"])
    C.get_nomad = lambda name, _cfg=cfg: _cfg
    rec = dryrun.run_nomad_cell("nomad_pubmed", multi, None)
    out[label] = {k: rec[k] for k in ("steps_per_epoch", "hierarchical", "analytic_terms", "memory", "n_chips",
                                      "mesh")}
    out[label]["coll_by_type"] = rec["hlo_cost"]["coll_by_type"]
out["hw"] = {k: v for k, v in HW_V5E.items() if isinstance(v, (int, float))}
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    spec = {"lm": [[label, arch, shape, multi, _overrides(arch)] for label, arch, shape, multi in LM_CELLS],
            "shapes": SHAPES, "nomad": NOMAD_CELLS, "nomad_kw": NOMAD}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(spec)], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REFERENCE ")][-1]
    return json.loads(line[len("REFERENCE "):])


def _port_cell(arch: str, shape: str, multi: bool) -> dict:
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    cfg = reduced(ARCHS[arch], **_overrides(arch))
    return dryrun.run_lm_cell(cfg, ShapeConfig(shape, *SHAPES[shape]), multi)


@pytest.mark.parametrize("label,arch,shape,multi", LM_CELLS, ids=[c[0] for c in LM_CELLS])
def test_lm_cell_against_the_reference(reference, label, arch, shape, multi):
    rec = _port_cell(arch, shape, multi)
    ref = reference[label]
    assert rec["ok"] and rec["n_chips"] == ref["n_chips"] and rec["mesh"] == ref["mesh"]
    mem, want_mem = rec["memory"], ref["memory"]
    got_dot, want_dot = rec["op_cost"]["dot_flops"], ref["hlo_cost"]["dot_flops"]
    got_coll, want_coll = rec["op_cost"]["coll_by_type"], ref["hlo_cost"]["coll_by_type"]
    print(f"\n{label}: argument {mem['argument_bytes']:.0f} vs {want_mem['argument_bytes']:.0f} B; output "
          f"{mem['output_bytes']:.0f} vs {want_mem['output_bytes']:.0f} B; temp {mem['temp_bytes']:.0f} vs XLA "
          f"{want_mem['temp_bytes']:.0f} B; dot {got_dot:.4e} vs XLA {want_dot:.4e} (one card / n "
          f"{rec['one_card']['dot_flops'] / rec['n_chips']:.4e}); collectives port {json.dumps(got_coll)} "
          f"XLA {json.dumps(want_coll)}")
    assert abs(mem["argument_bytes"] / want_mem["argument_bytes"] - 1.0) <= 0.01
    assert abs(mem["output_bytes"] / want_mem["output_bytes"] - 1.0) <= 0.01
    if want_dot > got_dot * 1.1:
        # XLA replicates work past the even split that the port bills: it
        # may only count more (ROADMAP queue 3 keeps the two numbers)
        assert shape in ("decode_32k", "long_500k"), (got_dot, want_dot)
    else:
        assert abs(got_dot / want_dot - 1.0) <= 0.10, (got_dot, want_dot)
    if SHAPES[shape][0] != "decode":
        # the activations' layout, not an even split, and the collectives'
        # total: within a factor 2 of XLA's (its buffers and its choice of
        # collectives differ; a decode step's temp and collectives are a few
        # kB to MB of XLA's own buffers: printed only)
        assert 0.5 <= mem["temp_bytes"] / want_mem["temp_bytes"] <= 2.0, (mem["temp_bytes"], want_mem["temp_bytes"])
        ratio = sum(got_coll.values()) / sum(want_coll.values())
        assert 0.5 <= ratio <= 2.0, (got_coll, want_coll)
    assert rec["op_cost"]["collective_bytes"] > 0 and rec["terms"]["collective_s"] > 0
    assert mem["per_device_total"] == pytest.approx(
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"])
    assert all(v == v and v >= 0 for v in rec["terms"].values() if isinstance(v, float))


@pytest.mark.parametrize("label,multi", NOMAD_CELLS, ids=[c[0] for c in NOMAD_CELLS])
def test_nomad_cell_against_the_reference(reference, label, multi):
    from repro_torch.configs import get_nomad
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import nomad_analytic_terms

    cfg = get_nomad("nomad_pubmed").replace(**NOMAD)
    rec = dryrun.run_nomad_cell(cfg, multi)
    ref = reference[label]
    assert rec["n_chips"] == ref["n_chips"] and rec["mesh"] == ref["mesh"]
    assert rec["steps_per_epoch"] == ref["steps_per_epoch"] and rec["hierarchical"] == ref["hierarchical"]
    terms = nomad_analytic_terms(cfg, rec["n_chips"], rec["steps_per_epoch"], reference["hw"])
    for k, v in ref["analytic_terms"].items():
        assert terms[k] == pytest.approx(v, rel=1e-9, abs=0.0), (k, terms[k], v)
    got_arg, want_arg = rec["memory"]["argument_bytes"], ref["memory"]["argument_bytes"]
    print(f"\n{label}: argument {got_arg:.0f} vs {want_arg:.0f} B; exchange port "
          f"{json.dumps(rec['collectives']['coll_by_type'])} XLA {json.dumps(ref['coll_by_type'])}")
    assert abs(got_arg / want_arg - 1.0) <= 0.01, (got_arg, want_arg)
    assert rec["collectives"]["collective_bytes"] > 0


def test_hierarchical_nomad_cell_bills_the_pod_exchange():
    from repro_torch.configs import get_nomad
    from repro_torch.launch import dryrun

    cfg = get_nomad("nomad_pubmed").replace(hierarchical=True, **NOMAD)
    flat = dryrun.run_nomad_cell(cfg, False)
    hier = dryrun.run_nomad_cell(cfg, True)
    assert not flat["hierarchical"] and hier["hierarchical"]
    d = cfg.out_dim
    assert flat["collectives"]["coll_by_type"] == {"all-gather": cfg.n_clusters * d * 4.0}
    assert hier["collectives"]["coll_by_type"] == {"all-gather": cfg.n_clusters // 2 * d * 4.0,
                                                    "all-reduce": (d + 1) * 4.0}


def test_cli_writes_both_meshes(tmp_path):
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", "nomad_pubmed", "--out", str(tmp_path)]) == 0
    for tag, n in (("pod16x16", 256), ("pod2x16x16", 512)):
        rec = json.loads((tmp_path / tag / "nomad_pubmed__epoch.json").read_text())
        assert rec["ok"] and rec["mesh"] == tag and rec["n_chips"] == n and rec["hw"] == "h100-sxm"
    assert not (tmp_path / "h100x1").exists()


def test_spec_collectives_rules():
    """The billing rules on one dense layer: zero-3 gathers and scatters,
    the row-split products' all-reduces, nothing for replicated leaves."""
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.launch import dryrun
    from repro_torch.models import lm

    cfg = dataclasses.replace(reduced(ARCHS["phi4-mini-3.8b"], **REDUCED), n_layers=1)
    mesh = dryrun.production_mesh(False)
    params = lm.abstract_params(cfg)
    from repro_torch.launch.sharding import param_pspec_tree

    specs = param_pspec_tree(cfg, mesh, params)
    train = ShapeConfig("t", "train", 256, 256)
    rep = dryrun.spec_collectives(cfg, train, mesh, params, specs, ("data",))
    T = 128 * 256 // 16
    gathered = sum(dryrun.local_bytes(p, [None if e == "data" else e for e in specs[n]], mesh)
                   for n, p in params.named_parameters() if "data" in dryrun._spec_axes(specs[n]))
    assert rep.coll_by_type["all-gather"] == pytest.approx(gathered * 2 * 2)
    assert rep.coll_by_type["reduce-scatter"] == pytest.approx(gathered * 2)
    # wo, w_down: fwd + bwd a microbatch; the embedding's lookup: fwd; the tied head: the input
    # gradient and the cross-entropy's two statistics
    act = 4
    want_ar = 2 * (2 * T * 256 * act) * 2 + 2 * T * 256 * act + 2 * T * 256 * act + 2 * T * 2 * 4
    assert rep.coll_by_type["all-reduce"] == pytest.approx(want_ar)
    assert "all-to-all" not in rep.coll_by_type



def test_op_counter_keeps_the_per_card_peak():
    """With ``split`` the counter also keeps the peak of each live
    storage's per-card share, beside the whole peak."""
    from repro_torch.roofline.op_cost import OpCounter

    def f(x):
        a = x * 2.0  # (64, 32) fp32, 8,192 B, split 4 ways
        return a.sum(0)  # (32,) fp32, 128 B, whole

    x = torch.ones(64, 32, device="meta")
    counter = OpCounter(split=lambda t: 4 if t.dim() == 2 else 1)
    with counter:
        f(x)
    assert counter.report.temp_bytes == 8192 + 128
    assert counter.local_temp_bytes == 8192 / 4 + 128


def test_layout_split_rules():
    """Activations over the batch axes, and over ``model`` where a width
    the weights split there appears (never d_model); weight-shaped
    tensors over every card."""
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import param_pspec_tree
    from repro_torch.models import lm

    cfg = dataclasses.replace(reduced(ARCHS["phi4-mini-3.8b"], **REDUCED), n_layers=1)
    mesh = dryrun.production_mesh(False)
    params = lm.abstract_params(cfg)
    split = dryrun.layout_split(cfg, ShapeConfig("t", "train", 256, 256), mesh, params,
                                param_pspec_tree(cfg, mesh, params), ("data",))
    seqs, tokens = 128, 128 * 256  # a microbatch of accum 2

    def meta(*shape):
        return torch.empty(shape, device="meta")

    assert split(meta(seqs, 256, 256)) == 16  # the residual stream (B, S, d_model)
    assert split(meta(seqs, 256, 512)) == 256  # (B, S, d_ff)
    assert split(meta(tokens, 1024)) == 256  # logits over the vocabulary
    assert split(meta(seqs * 16, 256, 32)) == 256  # (B·H, S, hd)
    assert split(meta(2, seqs, 256, 16, 32)) == 256  # a stacked cache (L, B, S, KV, hd)
    assert split(meta(256, 512)) == 256  # a weight's gradient
    assert split(meta()) == 1
