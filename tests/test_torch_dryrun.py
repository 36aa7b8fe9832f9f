"""The port's dry run on the CPU: the input specs (``lm.abstract_params``,
``steps.batch_specs`` / ``cache_specs`` / ``input_specs``, meta tensors)
against the JAX package's ``jax.eval_shape`` structures for every
(architecture × supported shape) cell its ``launch/dryrun.py`` visits, and
``launch.dryrun``'s cells.

The weights are compared through ``models/convert.py``'s name map: the
reference's abstract tree is carried across with every leaf made a meta
tensor of its per-layer shape and its dtype, and the result must equal
``abstract_params`` name for name. AdamW's moments follow the weights; the
one known difference: the reference decides int8 storage on its stacked
(L, …) leaves, the port on each layer's leaf, so a vector a layer (norm
scales) that the reference quantises when stacked keeps float32 moments in
the port, as the port's ``QUANT_MIN_SIZE`` rule says for small leaves.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import QTensor as JaxQTensor  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import convert, lm, steps  # noqa: E402
from repro_torch.optim import AdamW, QTensor, warmup_cosine  # noqa: E402
from repro_torch.optim.adamw import QUANT_MIN_SIZE  # noqa: E402
from repro_torch.roofline.analysis import HW_H100, nomad_analytic_terms  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the cells the reference's dry run visits: every arch, its supported shapes
CELLS = [(a, s) for a in sorted(ARCHS) for s in ARCHS[a].supported_shapes()]
_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16, "int32": torch.int32,
       "int8": torch.int8}


def _same(t: torch.Tensor, sds) -> bool:
    return t.device.type == "meta" and tuple(t.shape) == tuple(sds.shape) and t.dtype == _DT[str(sds.dtype)]


class _Pair:
    """A reference weight's abstract leaf beside its AdamW moments."""

    def __init__(self, p, mu):
        self.p, self.mu = p, mu

    @property
    def shape(self):
        return self.p.shape


@pytest.fixture(scope="module")
def ref_abstract():
    """Per arch: the reference's abstract params zipped with its AdamW
    (config moment dtype) state's ``mu``, and the state's ``count``."""
    out = {}
    for name in sorted(ARCHS):
        rcfg = ref_configs.ARCHS[name]
        params = ref_lm.abstract_params(rcfg)
        opt = JaxAdamW(schedule=jax_warmup_cosine(3e-4, 2000, 100_000), moment_dtype=rcfg.opt_moment_dtype)
        state = jax.eval_shape(opt.init, params)
        out[name] = (jax.tree.map(_Pair, params, state["mu"]), state["count"])
    return out


def _carried(monkeypatch, zipped, cfg):
    """``convert.from_reference`` over the zipped abstract tree: every leaf a
    meta tensor of its per-layer shape; returns (the LM, {storage key:
    (leaf name, reference moments, layer index)})."""
    where = {}

    def t(self, name):
        pair = convert._get(self.node, name)
        shape = tuple(pair.p.shape[len(self.index):])
        x = torch.empty(shape, dtype=_DT[str(pair.p.dtype)], device="meta")
        where[x.untyped_storage()._cdata] = (name, pair.mu, self.index)
        return x

    monkeypatch.setattr(convert._Leaves, "t", t)
    return convert.from_reference(zipped, cfg, device="meta"), where


def _cut(sds, index):
    return tuple(sds.shape[len(index):])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_and_moments_match_jax(arch, ref_abstract, monkeypatch):
    cfg = ARCHS[arch]
    zipped, count = ref_abstract[arch]
    carried, where = _carried(monkeypatch, zipped, cfg)
    port = lm.abstract_params(cfg)
    got = {n: (tuple(p.shape), p.dtype, p.device.type) for n, p in port.named_parameters()}
    want = {n: (tuple(p.shape), p.dtype, "meta") for n, p in carried.named_parameters()}
    assert got == want
    assert sum(p.numel() for p in port.parameters()) == sum(p.numel() for p in carried.parameters())

    opt = AdamW(schedule=warmup_cosine(3e-4, 2000, 100_000), moment_dtype=cfg.opt_moment_dtype)
    specs = steps.input_specs(cfg, SHAPES["train_4k"], opt)
    state = specs[1]
    assert state["count"] == 0 and count.shape == () and str(count.dtype) == "int32"
    params = list(carried.parameters())
    assert len(state["mu"]) == len(params) == len(list(specs[0].parameters()))
    per_layer_rule = 0
    for p, mv in zip(params, state["mu"]):
        name, ref_mu, index = where[p.untyped_storage()._cdata]
        for k in ("m", "v"):
            got_k, want_k = mv[k], ref_mu[k]
            if isinstance(got_k, QTensor):
                assert isinstance(want_k, JaxQTensor), name
                assert tuple(got_k.q.shape) == _cut(want_k.q, index) and got_k.q.dtype == torch.int8
                assert tuple(got_k.scale.shape) == _cut(want_k.scale, index) and got_k.scale.dtype == torch.float32
                assert got_k.sqrt_scaled == want_k.sqrt_scaled
            elif isinstance(want_k, JaxQTensor):
                # quantised by the reference as an (L, ...) stack; small a layer
                assert p.numel() < QUANT_MIN_SIZE <= math.prod(want_k.q.shape), name
                assert got_k.dtype == torch.float32 and got_k.shape == p.shape
                per_layer_rule += 1
            else:
                assert tuple(got_k.shape) == _cut(want_k, index) and got_k.dtype == _DT[str(want_k.dtype)], name
    # only vectors a layer differ (norm scales, per-head vectors)
    assert per_layer_rule == 0 or cfg.opt_moment_dtype == "int8"


class _Stateless:
    """An optimiser whose state is one fixed object (input_specs' slot)."""

    state = {"mu": [], "count": 0}

    def init(self, params):
        return self.state


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_cache_and_input_specs_match_jax(arch, shape):
    cfg, rcfg = ARCHS[arch], ref_configs.ARCHS[arch]
    sh, rsh = SHAPES[shape], ref_configs.SHAPES[shape]
    for labels, micro in ((True, True), (True, False), (False, False)):
        got = steps.batch_specs(cfg, sh, with_labels=labels, microbatched=micro)
        want = ref_steps.batch_specs(rcfg, rsh, with_labels=labels, microbatched=micro)
        assert sorted(got) == sorted(want)
        assert all(_same(got[k], want[k]) for k in want), (got, want)
    # AdamW's state on these weights is held to the reference's above
    opt = _Stateless()
    specs = steps.input_specs(cfg, sh, opt)
    if sh.kind == "train":
        assert len(specs) == 3 and specs[1] is opt.state
        want = ref_steps.batch_specs(rcfg, rsh, with_labels=True, microbatched=True)
        assert all(_same(specs[2][k], want[k]) for k in want)
    elif sh.kind == "prefill":
        assert len(specs) == 2
        want = ref_steps.batch_specs(rcfg, rsh, with_labels=False)
        assert sorted(specs[1]) == sorted(want) and all(_same(specs[1][k], want[k]) for k in want)
    else:
        assert len(specs) == 3
        cache, want = specs[1], ref_steps.cache_specs(rcfg, rsh)
        assert sorted(cache) == sorted(want)
        # the port keeps the step count a Python int (the host knows it)
        assert cache["idx"] == rsh.seq_len - 1 and want["idx"].shape == () and str(want["idx"].dtype) == "int32"
        assert all(_same(cache[k], want[k]) for k in want if k != "idx"), {k: (cache[k].shape, want[k]) for k in want
                                                                            if k != "idx"}
        assert _same(specs[2], jax.ShapeDtypeStruct((rsh.global_batch, 1), jnp.int32))
    assert isinstance(specs[0], lm.LM) and all(p.device.type == "meta" for p in specs[0].parameters())


SMALL = {"train": dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4),
         "prefill": dataclasses.replace(SHAPES["prefill_32k"], seq_len=32, global_batch=2),
         "decode": dataclasses.replace(SHAPES["decode_32k"], seq_len=48, global_batch=2)}


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in ("phi4-mini-3.8b", "mixtral-8x7b", "mamba2-2.7b", "jamba-1.5-large-398b", "hubert-xlarge",
                     "internvl2-76b")
    for k in sorted(SMALL) if SMALL[k].name in ARCHS[a].supported_shapes()])
def test_run_lm_cell_reduced(arch, kind):
    shape = SMALL[kind]
    cfg = reduced(ARCHS[arch], accum_steps=2, remat="full", opt_moment_dtype="int8", attn_chunk=16,
                  attn_impl="flash", ssm_chunk=16)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_period)  # one meta-block
    rec = dryrun.run_lm_cell(cfg, shape)
    assert rec["ok"] and rec["kind"] == kind and rec["n_chips"] == 1 and rec["device"] == "h100x1"
    t, m, c = rec["terms"], rec["memory"], rec["op_cost"]
    assert all(np.isfinite(t[k]) and t[k] >= 0 for k in ("compute_s", "memory_s", "collective_s", "bound_s"))
    assert t["collective_s"] == 0 and t["dominant"] in ("compute", "memory")
    assert m["fits"] and m["per_device_total"] == m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] - \
        m["alias_bytes"]
    assert c["dot_flops"] > 0 and c["flops"] >= c["dot_flops"] and c["bytes"] > 0 and c["unknown_trip_whiles"] == 0
    assert rec["model_flops"] > 0
    if kind == "train":  # the weights are updated in place: the result's weights alias the arguments
        assert m["alias_bytes"] >= sum(p.numel() * p.element_size() for p in lm.abstract_params(cfg).parameters())
    json.dumps(rec)


def test_run_lm_cell_does_not_fit_is_reported():
    rec = dryrun.run_lm_cell("phi4-mini-3.8b", "decode_32k")
    assert rec["ok"] and not rec["memory"]["fits"]
    assert rec["memory"]["per_device_total"] > HW_H100["hbm_bytes"]


def test_run_nomad_cell():
    rec = dryrun.run_nomad_cell("nomad_pubmed")
    from repro_torch.configs import PUBMED

    steps_ = PUBMED.resolved_steps_per_epoch()
    assert rec["ok"] and not rec["traced"] and rec["steps_per_epoch"] == steps_
    assert rec["analytic_terms"] == nomad_analytic_terms(PUBMED, 1, steps_, HW_H100)
    rows = PUBMED.n_clusters * PUBMED.cluster_capacity
    assert rec["rows"] == rows
    assert rec["memory"]["state_bytes"]["theta"] == rows * PUBMED.out_dim * 4
    assert rec["memory"]["per_device_total"] == sum(rec["memory"]["state_bytes"].values())
    assert rec["memory"]["fits"] and rec["model_flops"] > 0
    assert rec["terms"]["dominant"] in ("compute", "memory", "collective")
    assert rec["terms"]["bound_s"] == max(rec["analytic_terms"].values())


def test_cli_writes_cells_and_skips_existing(tmp_path, capsys):
    assert dryrun.main(["--arch", "nomad_pubmed", "--out", str(tmp_path), "--mesh", "one"]) == 0
    path = tmp_path / "h100x1" / "nomad_pubmed__epoch.json"
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["arch"] == "nomad_pubmed"
    assert dryrun.main(["--arch", "nomad_pubmed", "--out", str(tmp_path), "--mesh", "one", "--skip-existing"]) == 0
    assert "SKIP (exists)" in capsys.readouterr().out
    assert dryrun.cells("hubert-xlarge", "decode_32k") == []
    assert dryrun.cells("all", "all")[-2:] == [("nomad_pubmed", "epoch"), ("nomad_wiki60m", "epoch")]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "nomad_pubmed", "--mesh", "2"])
    assert e.value.code == 2
