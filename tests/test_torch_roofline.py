"""The port's roofline (``repro_torch.roofline``) against the JAX package's
on the CPU: ``analysis.py``'s formulas give the reference's floats for the
same hardware table over every ``ARCHS`` × ``SHAPES`` cell, and the op
counter (``op_cost.analyze_ops``) counts the matrix products the reference's
HLO parser counts in the same functions.

The one difference named: the port's prefill step takes the vocabulary
product at the last position only, where the reference's takes it at all S
and slices (``models/steps.py``), so the reference counts 2·B·(S−1)·D·V more.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline.hlo_cost import CostReport as RefCostReport  # noqa: E402
from repro.roofline.hlo_cost import analyze_hlo  # noqa: E402
from repro_torch.configs import ARCHS, NOMAD_WORKLOADS, SHAPES, reduced  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.op_cost import CostReport, analyze_ops, memory_analysis  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HWS = {"h100": analysis.HW_H100, "v5e": dict(ref_analysis.HW_V5E)}
CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]


def test_h100_table():
    hw = analysis.HW_H100
    assert (hw["peak_flops"], hw["peak_flops_tf32"], hw["peak_flops_fp32"]) == (989e12, 495e12, 67e12)
    assert (hw["hbm_bw"], hw["hbm_bytes"], hw["ici_bw"], hw["name"]) == (3.35e12, 80e9, 450e9, "h100-sxm")
    assert abs(hw["sfu_rate"] - 4.18e12) < 0.01e12
    assert not any(v == ref_analysis.HW_V5E[k] for k, v in hw.items() if k in ref_analysis.HW_V5E)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    cfg, rcfg = ARCHS[arch], ref_configs.ARCHS[arch]
    sh, rsh = SHAPES[shape], ref_configs.SHAPES[shape]
    assert analysis.model_flops(cfg, sh) == ref_analysis.model_flops(rcfg, rsh)
    B, S = sh.global_batch, sh.seq_len
    assert analysis._attention_flops(cfg, B, S) == ref_analysis._attention_flops(rcfg, B, S)


@pytest.mark.parametrize("hw", sorted(HWS))
def test_terms_equal_jax(hw):
    table = HWS[hw]
    for flops, nbytes, coll, chips, mf in [(1e15, 3e12, 0.0, 1, 4e14), (2e12, 5e9, 1e8, 256, 1e14), (0, 0, 0, 1, 0)]:
        got = analysis.roofline_terms(CostReport(flops=flops, bytes=nbytes, collective_bytes=coll), chips, mf, table)
        want = ref_analysis.roofline_terms(RefCostReport(flops=flops, bytes=nbytes, collective_bytes=coll), chips, mf,
                                           table)
        for f in ("compute_s", "memory_s", "collective_s", "model_flops", "hlo_flops_global", "useful_ratio",
                  "dominant", "bound_s", "roofline_fraction"):
            assert getattr(got, f) == getattr(want, f), f
    for flops, nbytes, us in [(1e9, 1e6, 10.0), (1e6, 1e9, 300.0), (1.0, 1.0, 0.0)]:
        assert analysis.kernel_roofline(flops, nbytes, us, table) == ref_analysis.kernel_roofline(flops, nbytes, us,
                                                                                                  table)
    for name in sorted(NOMAD_WORKLOADS):
        cfg, rcfg = NOMAD_WORKLOADS[name], ref_configs.NOMAD_WORKLOADS[name]
        for chips in (1, 4):
            steps_ = max(1, -(-cfg.resolved_steps_per_epoch() // chips))
            assert analysis.nomad_analytic_terms(cfg, chips, steps_, table) == \
                ref_analysis.nomad_analytic_terms(rcfg, chips, steps_, table)
        args = (cfg.n_points, cfg.batch_size, cfg.n_neighbors, cfg.n_exact_negatives, cfg.n_clusters, 7)
        assert analysis.nomad_model_flops(*args) == ref_analysis.nomad_model_flops(*args)


def test_model_flops_sanity():
    """The reference's ``tests/test_roofline.py`` bands, on the port."""
    cfg = ARCHS["phi4-mini-3.8b"]
    mf_train = analysis.model_flops(cfg, SHAPES["train_4k"])
    assert 1e16 < mf_train < 6e16, mf_train
    mf_dec = analysis.model_flops(cfg, SHAPES["decode_32k"])
    assert mf_dec < mf_train / 1000
    moe = ARCHS["mixtral-8x7b"].param_counts()
    assert moe["active"] < 0.4 * moe["total"]
    jam = ARCHS["jamba-1.5-large-398b"].param_counts()
    assert 3.0e11 < jam["total"] < 5.5e11, jam


D = 256


def _mlp(a, b, c):
    return torch.relu(a @ b) @ c


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_analyze_ops_counts_a_matmul_chain_like_the_hlo_parser(device):
    a, b, c = (torch.randn(D, D, device=device) for _ in range(3))
    out, rep = analyze_ops(_mlp, a, b, c)
    assert out.shape == (D, D) and out.device.type == device
    assert rep.dot_flops == 4 * D**3  # exactly: two (D, D) x (D, D) products
    assert rep.flops == 4 * D**3 + D * D  # and the relu, one a element
    assert rep.dot_by_op == {"mm": 4 * D**3}
    sds = jax.ShapeDtypeStruct((D, D), jnp.float32)
    hlo = jax.jit(lambda a, b, c: jax.nn.relu(a @ b) @ c).lower(sds, sds, sds).compile().as_text()
    ref = analyze_hlo(hlo)
    assert abs(rep.dot_flops - ref.dot_flops) / ref.dot_flops < 0.01
    assert abs(rep.flops - ref.flops) / ref.flops < 0.02
    assert rep.collective_bytes == 0 and rep.unknown_trip_whiles == 0 and rep.coll_by_type == {}
    # bytes: mm reads 2 and writes 1, relu reads 1 and writes 1, the last mm 3
    assert rep.bytes == 8 * D * D * 4
    mem = memory_analysis((a, b, c), out, rep)
    assert mem["argument_bytes"] == 3 * D * D * 4 and mem["output_bytes"] == D * D * 4
    assert mem["alias_bytes"] == 0 and mem["per_device_total"] == 3 * D * D * 4 + rep.temp_bytes


def test_analyze_ops_rules():
    """Views are free, a gather bills twice its output, an in-place op
    twice its written region plus its other operands, a scatter twice its
    update; ``temp_bytes`` is the peak of live new storage."""
    x = torch.zeros(64, 32)
    idx = torch.arange(8)

    def views(x):
        return x.view(32, 64).t()[:4]

    _, rep = analyze_ops(views, x)
    assert rep.bytes == 0 and rep.flops == 0 and rep.temp_bytes == 0
    _, rep = analyze_ops(lambda x: x[idx], x)
    assert rep.bytes == 2 * 8 * 32 * 4
    y = torch.ones(64, 32)
    _, rep = analyze_ops(lambda x, y: x.add_(y), x, y)
    assert rep.bytes == 2 * 64 * 32 * 4 + 64 * 32 * 4 and rep.flops == 64 * 32
    _, rep = analyze_ops(lambda x: x[:8].copy_(torch.ones(8, 32)), x)
    assert rep.bytes == 8 * 32 * 4 + 2 * 8 * 32 * 4  # the fill writes its rows; the copy reads and writes them
    upd = torch.ones(8, 32)
    _, rep = analyze_ops(lambda x: x.index_add_(0, idx, upd), x)
    assert rep.bytes == 2 * 8 * 32 * 4

    def temps(x):
        big = torch.zeros(1000, 1000)  # 4 MB, dead after the sum
        s = big.sum()
        del big
        return x + s

    out, rep = analyze_ops(temps, x)
    assert rep.temp_bytes == 4_000_000 + 4  # the zeros and the sum's scalar, live together
    assert memory_analysis((x,), out, rep)["temp_bytes"] == 4_000_004 - 64 * 32 * 4  # less the result


def _train_cell(device: str):
    cfg = reduced(ARCHS["phi4-mini-3.8b"], accum_steps=2, remat="full", opt_moment_dtype="int8", attn_chunk=16,
                  attn_impl="flash")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
    from repro_torch.optim import AdamW, warmup_cosine

    opt = AdamW(schedule=warmup_cosine(3e-4, 2000, 100_000), moment_dtype=cfg.opt_moment_dtype)
    specs = steps.input_specs(cfg, shape, opt)
    if device == "cpu":
        params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
        batch = {k: torch.randint(0, cfg.vocab_size, v.shape, dtype=v.dtype) for k, v in specs[2].items()}
        specs = (params, opt.init(list(params.parameters())), batch)
    return steps.make_train_step(cfg, opt, microbatched=True), specs


def test_meta_counts_equal_cpu_counts():
    """A train step (accum 2, remat full, flash, int8 moments) counted on
    meta tensors and on CPU tensors: the same ops, FLOPs and bytes. Each
    device's first run fills the rope frequencies' per-device cache (one
    copy op), so the second run of each is compared."""
    reps = {}
    for device in ("meta", "cpu"):
        for _ in range(2):
            step, specs = _train_cell(device)
            out, rep = analyze_ops(step, *specs)
        reps[device] = (rep, memory_analysis(specs, out, rep))
    (m, mm), (c, cm) = reps["meta"], reps["cpu"]
    assert m.dot_flops > 0 and m.unknown_trip_whiles == 0
    for f in ("flops", "bytes", "dot_flops", "ops", "temp_bytes", "dot_by_op"):
        assert getattr(m, f) == getattr(c, f), f
    assert mm == cm


def _prefill_pair(arch: str, n_layers: int, B: int = 2, S: int = 32):
    cfg = reduced(ARCHS[arch], n_layers=n_layers)
    rcfg = ref_configs.reduced(ref_configs.ARCHS[arch], n_layers=n_layers)
    _, rep = analyze_ops(steps.make_prefill_step(cfg), lm.abstract_params(cfg),
                         {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")})
    params = jax.eval_shape(lambda k: ref_lm.init_params(k, rcfg), jax.random.key(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    ref = analyze_hlo(jax.jit(ref_steps.make_prefill_step(rcfg)).lower(params, batch).compile().as_text())
    return cfg, rep, ref


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mixtral-8x7b"])
def test_prefill_dot_flops_equal_hlo_parser(arch, n_layers):
    B, S = 2, 32
    cfg, rep, ref = _prefill_pair(arch, n_layers, B, S)
    # the reference's vocabulary product at the S - 1 positions it slices away
    logits_rest = 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab_padded
    assert rep.dot_flops == ref.dot_flops - logits_rest
    assert rep.unknown_trip_whiles == ref.unknown_trip_whiles == 0
