"""The kernel registry's specs and the autotuner (``repro_torch.kernels.
registry.KernelSpec``, ``repro_torch.kernels.autotune``), on the CPU.

From the JAX package's ``tests/test_autotune_v2.py``: shape buckets, cache
keys, source-hash invalidation, corrupt / truncated / foreign / stale
cache files degrading to a fresh sweep, concurrent stores, and the sweep's
report kept off the disk. No kernel runs here, so a sweep is driven
through a spec whose CUDA entry is its plain version (the tuner's
machinery is what is under test; ``chip_smoke.py:autotune_check`` sweeps
the real kernels on the card).

From ``tests/test_kernel_registry.py``, the contracts that apply: every
spec complete, its check and bench shapes, tolerance and (forward) cost
model the reference spec's, ``validate`` refusing CPU tensors and the
plain-only ``capacity_admit``; and the port's own: the only plans offered
besides the default are K2's chunk counts and K3's tiles, and neither a
validate nor a sweep counts a launch.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.kernels import registry as ref_registry  # noqa: E402
from repro_torch.kernels import autotune, registry  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


def _on_cpu(name: str) -> registry.KernelSpec:
    """Spec ``name`` with its plain version in place of the kernel: what a
    sweep on the CPU can run."""
    sp = registry.spec(name)
    return dataclasses.replace(sp, cuda=lambda *args, plan=None: sp.plain(*args))


# ---------------------------------------------------------------------------
# Shape buckets and keys
# ---------------------------------------------------------------------------


def test_bucket_examples():
    assert autotune.bucket_dim(64) == 64
    assert autotune.bucket_dim(128) == 128
    assert autotune.bucket_dim(129) == 256
    assert autotune.bucket_dim(49_000) == autotune.bucket_dim(50_000) == 65_536


@given(n=st.integers(min_value=1, max_value=10_000_000))
@settings(max_examples=200, deadline=None)
def test_bucket_dim_is_idempotent_and_covers(n):
    b = autotune.bucket_dim(n)
    assert b >= n and autotune.bucket_dim(b) == b
    if n <= 128:
        assert b == n
    else:
        assert b & (b - 1) == 0 and b < 2 * n


@given(n=st.integers(min_value=129, max_value=10_000_000))
@settings(max_examples=100, deadline=None)
def test_same_bucket_means_same_cache_key(n):
    b = autotune.bucket_dim(n)
    lo = max(b // 2 + 1, 129)
    assert autotune.cache_key("k", "cpu", (((n, 64), "float32"),)) == autotune.cache_key(
        "k", "cpu", (((lo, 64), "float32"),))


@given(entries=st.lists(st.tuples(st.lists(st.integers(min_value=1, max_value=100_000), min_size=1, max_size=3),
                                  st.sampled_from(["float32", "bfloat16", "int32"])), min_size=1, max_size=4))
@settings(max_examples=100, deadline=None)
def test_cache_key_stable_under_bucketing(entries):
    sig = tuple((tuple(shape), dt) for shape, dt in entries)
    assert autotune.cache_key("k", "cpu", sig) == autotune.cache_key("k", "cpu", autotune.bucket_sig(sig))
    assert autotune.cache_key("k", "cpu", sig) == autotune.cache_key("k", "cpu", sig)


def test_the_key_names_kernel_card_and_bucket():
    sig = (((1000, 64), "float32"),)
    assert autotune.cache_key("pairwise", "NVIDIA H100 80GB HBM3", sig) == \
        "pairwise|NVIDIA H100 80GB HBM3|(((1024, 64), 'float32'),)"
    assert autotune.card_name(CPU) == "cpu"


def test_shapes_in_one_bucket_share_a_recorded_winner(tune_env, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    sp = registry.spec("pairwise")
    sig_a = (((49_000, 64), "float32"), ((256, 64), "float32"))
    sig_b = (((50_000, 64), "float32"), ((256, 64), "float32"))
    planted = {"plan": {"tile": 64}, "us": 5.0}
    autotune.record(sp, sig_a, planted, device=CPU)
    assert autotune.plan_for(sp, sig_b, device=CPU) == planted["plan"]
    autotune.clear_memory_cache()  # a fresh process reloads the winner from disk
    assert autotune.plan_for(sp, sig_b, device=CPU) == planted["plan"]


def test_without_a_winner_each_shape_gets_its_own_default_plan(tune_env, monkeypatch):
    """Tuning off and nothing cached: two shapes of one bucket each get the
    default plan at their own shape (K2's chunk count follows N's row
    blocks), never the other's, and nothing is written."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    sp = registry.spec("kmeans_assign")
    a, b = kmeans_ops._sig(1025, 4096, 768), kmeans_ops._sig(2048, 4096, 768)
    assert autotune.bucket_sig(a) == autotune.bucket_sig(b)
    assert autotune.plan_for(sp, a, device=CPU) == {"chunks": 11}
    assert autotune.plan_for(sp, b, device=CPU) == {"chunks": 8}
    assert autotune.plan_for(sp, a, device=CPU) == {"chunks": 11}
    assert not tune_env.exists()


def test_sweeping_is_opt_in(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert not autotune.autotune_enabled()
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert autotune.autotune_enabled()


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 1 << 20), st.integers(1, 1 << 15), st.sampled_from([1, 78, 114, 132]))
def test_the_wrappers_default_through_the_tuner_is_the_planners_split(n, k, sms):
    """K2's wrapper, with no plan and no winner, runs ``chunk_plan(k,
    default chunks)``: the split :func:`plan` chose before the tuner."""
    assert kmeans_ops.chunk_plan(k, kmeans_ops.plan(n, k, sms)[0]) == kmeans_ops.plan(n, k, sms)


# ---------------------------------------------------------------------------
# Source-hash invalidation
# ---------------------------------------------------------------------------


def _plant(path, key, plan, src):
    path.write_text(json.dumps({"version": autotune.CACHE_VERSION,
                                "entries": {key: {"plan": plan, "us": 1.0, "src": src}}}))


def test_source_hash_covers_the_ops_package_and_the_csrc_sources():
    hashes = {n: autotune.source_hash(registry.spec(n)) for n in registry.spec_names()}
    assert hashes["capacity_admit"] == "plain-only"
    for n, h in hashes.items():
        if n != "capacity_admit":
            assert re.fullmatch(r"[0-9a-f]{16}", h), (n, h)
    assert hashes["nomad_step_fwd"] == hashes["nomad_step_bwd"]  # one package, one .cu
    assert len({hashes[n] for n in ("pairwise", "kmeans_assign", "nomad_step_fwd", "cauchy_mean_fwd",
                                    "frozen_attract_fwd")}) == 5


def test_matching_source_hash_serves_cached_plans(tune_env, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    sp = registry.spec("pairwise")
    sig = sp.check_shapes[0]
    _plant(tune_env, autotune.cache_key(sp.name, "cpu", sig), {"tile": 64}, autotune.source_hash(sp))
    autotune.clear_memory_cache()
    assert autotune.plan_for(sp, sig, device=CPU) == {"tile": 64}


def test_stale_source_hash_is_ignored(tune_env, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    sp = registry.spec("pairwise")
    sig = sp.check_shapes[0]
    _plant(tune_env, autotune.cache_key(sp.name, "cpu", sig), {"tile": 64}, "0000deadbeef0000")
    autotune.clear_memory_cache()
    assert autotune.plan_for(sp, sig, device=CPU) == sp.default_plan(sig, CPU) == {"tile": 128}


def test_unknown_kernel_entries_are_skipped(tune_env, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    _plant(tune_env, "no_such_kernel|cpu|()", {"x": 1}, "whatever")
    autotune.clear_memory_cache()
    sp = registry.spec("pairwise")
    autotune.plan_for(sp, sp.check_shapes[0], device=CPU)
    assert "no_such_kernel|cpu|()" not in autotune._memory_cache


# ---------------------------------------------------------------------------
# Hostile file system
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("content", [
    "{definitely not json",
    '{"version": 2, "entries": {"k": {"pla',
    '{"pairwise|cpu|()": {"plan": {"tile": 64}}}',
    '{"version": 99, "entries": {}}',
    "[1, 2, 3]",
])
def test_unusable_cache_file_degrades_to_fresh_sweep(tune_env, content):
    tune_env.write_text(content)
    sp = _on_cpu("pairwise")
    sig = sp.check_shapes[0]
    plan = autotune.plan_for(sp, sig, device=CPU)
    assert plan in [dict(p) for p in sp.plan_candidates(sig)]
    blob = json.loads(tune_env.read_text())
    assert blob["version"] == autotune.CACHE_VERSION
    assert blob["entries"][autotune.cache_key(sp.name, "cpu", sig)]["plan"] == plan


def test_concurrent_stores_leave_a_valid_cache(tune_env):
    threads = [threading.Thread(target=autotune._store_disk,
                                args=(f"k{i}|cpu|()", {"plan": {"chunks": i}, "us": 1.0, "src": "x"}))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    blob = json.loads(tune_env.read_text())
    assert blob["version"] == autotune.CACHE_VERSION and blob["entries"]
    assert all("plan" in e for e in blob["entries"].values())


def test_a_failed_sweep_does_not_poison_the_disk(tune_env):
    """The real spec on the CPU: its kernel refuses CPU tensors, every plan
    fails, the default plan is served and nothing is written."""
    sp = registry.spec("kmeans_assign")
    sig = sp.check_shapes[0]
    assert autotune.plan_for(sp, sig, device=CPU) == sp.default_plan(sig, CPU)
    assert not tune_env.exists()


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def test_sweep_report_lists_candidates_and_disk_strips_them(tune_env):
    sp = _on_cpu("kmeans_assign")
    sig = sp.check_shapes[2]  # K 512: chunk counts 1, 2, 4
    before = registry.launch_counts()
    entry = autotune.sweep(sp, sig, device=CPU, report=True)
    assert registry.launch_counts() == before
    assert entry["src"] == autotune.source_hash(sp)
    assert [c["plan"] for c in entry["candidates"]][0] == sp.default_plan(sig, CPU)
    assert sorted(c["plan"]["chunks"] for c in entry["candidates"]) == [1, 2, 4]
    assert all(c["bit_equal"] and c["us"] > 0 for c in entry["candidates"])
    assert len(entry["candidates"]) == entry["n_candidates"]
    assert min(c["us"] for c in entry["candidates"]) == entry["us"]
    autotune.record(sp, sig, entry, device=CPU)
    blob = json.loads(tune_env.read_text())
    assert "candidates" not in blob["entries"][autotune.cache_key(sp.name, "cpu", sig)]


def test_a_plan_that_changes_a_bit_is_never_the_winner(tune_env):
    sp = registry.spec("pairwise")
    sig = sp.check_shapes[0]
    default = sp.default_plan(sig, CPU)

    def cuda(x, y, plan=None):
        out = sp.plain(x, y)
        return out if plan == default else torch.nextafter(out, torch.full_like(out, float("inf")))

    entry = autotune.sweep(dataclasses.replace(sp, cuda=cuda), sig, device=CPU, report=True)
    assert entry["plan"] == default and entry["n_candidates"] == 1
    assert [c["bit_equal"] for c in entry["candidates"]] == [True, False]


# ---------------------------------------------------------------------------
# The registry's specs
# ---------------------------------------------------------------------------


FORWARD = {"pairwise", "kmeans_assign", "nomad_step_fwd", "cauchy_mean_fwd", "frozen_attract_fwd", "capacity_admit"}


@pytest.mark.parametrize("name", registry.spec_names())
def test_every_spec_is_complete_and_the_references(name):
    sp = registry.spec(name)
    ref = ref_registry.get(sp.reference)
    assert callable(sp.plain) and callable(sp.make_inputs) and callable(sp.plan_candidates)
    assert sp.check_shapes == ref.check_shapes and sp.bench_shapes == ref.bench_shapes
    if sp.cuda is None:  # plain-only: the reference's jnp-only kernel
        assert ref.pallas is None and name not in registry.names() and sp.dtype_grid == ()
        return
    assert name in registry.names() and sp.tol == tuple(ref.tol) and sp.dtype_grid == ("float32",)
    assert callable(sp.cuda) and callable(sp.cost_model)
    for sig in sp.check_shapes + (sp.bench_shapes,):
        cost = sp.cost_model(sig)
        if name in FORWARD:
            assert cost == ref.cost_model(sig), (name, sig)
        assert cost["flops"] > 0 and cost["bytes"] > 0
        plans = sp.plan_candidates(sig)
        assert sp.default_plan(sig, CPU) in [dict(p) for p in plans]


@pytest.mark.parametrize("name", registry.spec_names())
def test_make_inputs_draw_the_signature_and_the_plain_version_runs(name):
    sp = registry.spec(name)
    for i, sig in enumerate(sp.check_shapes):
        args = sp.make_inputs(torch.Generator().manual_seed(i), sig)
        # a backward entry draws the forward's arguments, then its residuals and cotangent
        got = registry.shape_sig(args)[: len(sig) if name in FORWARD else 4]
        assert [s for s, _ in got] == [tuple(s) for s, _ in sig[: len(got)]]
        for (_, dt), (_, want) in zip(got, sig):
            assert dt == (want if want in ("int32", "bool") or not sp.dtype_grid else "float32")
        out = sp.plain(*args)
        assert all(bool(torch.isfinite(t.float()).all()) for t in registry.output_leaves(out))


def test_only_k2_and_k3_offer_more_than_one_plan():
    many = {n for n in registry.spec_names()
            if any(len(registry.spec(n).plan_candidates(s)) > 1 for s in registry.spec(n).check_shapes)}
    assert many == {"kmeans_assign", "pairwise"}
    assert kmeans_ops.chunk_plan(4096, 16) == (16, 256) and kmeans_ops.chunk_plan(4096, 3) == (3, 1408)
    assert kmeans_ops.chunk_plan(300, 64) == (3, 128)


@pytest.mark.parametrize("name", registry.spec_names())
def test_validate_refuses_the_cpu_and_plain_only_kernels(name):
    sp = registry.spec(name)
    args = sp.make_inputs(torch.Generator().manual_seed(0), sp.check_shapes[0])
    with pytest.raises(ValueError, match="plain-only" if sp.cuda is None else "no kernel runs on the CPU"):
        registry.validate(name, args)


def test_fixed_plans_refuse_another_plan():
    sp = registry.spec("cauchy_mean_fwd")
    args = sp.make_inputs(torch.Generator().manual_seed(0), sp.check_shapes[0])
    with pytest.raises(ValueError, match="plan is fixed"):
        sp.cuda(*args, plan={"chunks": 3, "chunk_len": 32})
    with pytest.raises(ValueError, match="not on a CUDA device"):  # the right plan reaches the kernel
        sp.cuda(*args, plan=sp.default_plan(registry.shape_sig(args), CPU))


def test_uncounted_launches_and_dispatch_by_device_alone():
    k = registry.get("pairwise")
    before = k.launches
    with registry.uncounted():
        registry.count_launch(k)
    assert k.launches == before
    registry.count_launch(k)
    assert k.launches == before + 1
    k.launches = before
    x = torch.randn(4, 3)
    assert torch.equal(registry.dispatch("pairwise", x, x), registry.spec("pairwise").plain(x, x))
