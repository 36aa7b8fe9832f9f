"""The port's inverse head, its optimiser and ``explore`` on the CPU, against
the JAX package's (``repro.pipeline.inverse``, ``repro.optim``,
``MapService.explore``) on the same numpy inputs.

The data is the JAX package's own pipeline run at the size of
``tests/test_pipeline.py`` (a tiny dense embedder, 256 documents at
d_model 128, a 4-epoch map, a 300-step head saved beside its checkpoint).
Heads trained by the two frameworks differ (threefry against Philox
draws), so training is compared one step at a time from the same
parameters and the same minibatch; a trained head is compared through
its file, both ways.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import PIPELINE_WORKLOADS  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import linear_decay as jax_linear_decay  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.pipeline import inverse as jax_inverse  # noqa: E402
from repro.pipeline import run_pipeline  # noqa: E402
from repro.service import MapService as JaxMapService  # noqa: E402
from repro_torch.optim import AdamW, constant, linear_decay, warmup_cosine  # noqa: E402
from repro_torch.pipeline import (  # noqa: E402
    InverseProjection,
    inverse_from_frozen,
    inverse_path,
    load_inverse,
    roundtrip_score,
    save_inverse,
    train_inverse,
)
from repro_torch.pipeline.inverse import train_step  # noqa: E402
from repro_torch.serve import FrozenMap  # noqa: E402
from repro_torch.service import MapService  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's work here runs at small shapes: one intra-op thread runs
    it faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX package's committed floor for the round-trip R² at this size
# (tests/test_pipeline.py)
ROUNDTRIP_R2_FLOOR = 0.15


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """The JAX package's tiny pipeline (tests/test_pipeline.py's fixture):
    its checkpoint directory holds the map and a JAX-trained inverse.npz."""
    w = dataclasses.replace(PIPELINE_WORKLOADS["pipeline_phi4_mini"], n_docs=256, seq_len=32, doc_batch=64,
                            n_epochs=2, n_clusters=8)
    d = str(tmp_path_factory.mktemp("pipeline"))
    return run_pipeline(w, d, inverse_steps=300, nomad_overrides={"n_epochs": 4})


@pytest.fixture(scope="module")
def port_frozen(pipeline_run):
    return FrozenMap.from_checkpoint(pipeline_run.checkpoint_dir, device="cpu")


# ---------------------------------------------------------------------------
# Optimiser: schedules and AdamW against repro.optim
# ---------------------------------------------------------------------------


def test_schedules_match_jax():
    pairs = [
        (constant(3e-3), jax_constant(3e-3)),
        (linear_decay(0.5, 40, floor=0.01), jax_linear_decay(0.5, 40, floor=0.01)),
        (warmup_cosine(3e-3, 10, 100), jax_warmup_cosine(3e-3, 10, 100)),
        (warmup_cosine(1.0, 1, 7, floor_frac=0.0), jax_warmup_cosine(1.0, 1, 7, floor_frac=0.0)),
    ]
    for ours, theirs in pairs:
        for step in range(0, 121, 3):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=1e-9)


def test_adamw_five_updates_match_jax():
    """Five updates under warmup_cosine from the same params and grads
    (matrices and biases: the weight decay reaches the matrices only)."""
    rng = np.random.default_rng(0)
    shapes = [(2, 16), (16,), (16, 8), (8,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    kw = dict(weight_decay=1e-2)
    opt = AdamW(schedule=warmup_cosine(3e-2, 2, 5), **kw)
    jopt = JaxAdamW(schedule=jax_warmup_cosine(3e-2, 2, 5), **kw)
    p = [torch.from_numpy(a) for a in params]
    jp = [jnp.asarray(a) for a in params]
    st, jst = opt.init(p), jopt.init(jp)
    for g in grads:
        p, st = opt.update(p, [torch.from_numpy(a) for a in g], st)
        jp, jst = jopt.update(jp, [jnp.asarray(a) for a in g], jst)
        for a, b in zip(p, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert st["count"] == int(jst["count"]) == 5
    for mv, jmv in zip(st["mu"], jst["mu"]):
        np.testing.assert_allclose(mv["m"].numpy(), np.asarray(jmv["m"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mv["v"].numpy(), np.asarray(jmv["v"]), rtol=1e-6, atol=1e-7)


def test_adamw_first_step_reads_schedule_at_one():
    """The schedule is read at the incremented count: at lr(0) = 0 the
    first update would do nothing; at lr(1) it moves."""
    opt = AdamW(schedule=warmup_cosine(1.0, 10, 100), weight_decay=0.0)
    p = [torch.ones(3)]
    new, _ = opt.update(p, [torch.ones(3)], opt.init(p))
    np.testing.assert_allclose(new[0].numpy(), 1.0 - 0.1 * (1.0 / (1.0 + 1e-8)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_adamw_other_moment_dtypes_match_jax(dtype):
    """The bfloat16 and int8 moments: five updates of the head's layer
    shapes and one leaf past ``QUANT_MIN_SIZE`` (int8 payloads there), the
    weights within 1e-6 of JAX's and the stored moments equal."""
    from repro.optim.quantized import QTensor as JaxQTensor
    from repro_torch.optim import QTensor

    rng = np.random.default_rng(1)
    shapes = [(2, 128), (128,), (128, 128), (300, 256)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    kw = dict(weight_decay=1e-4, moment_dtype=dtype)
    opt = AdamW(schedule=constant(1e-3), **kw)
    jopt = JaxAdamW(schedule=jax_constant(1e-3), **kw)
    p, jp = [torch.from_numpy(a) for a in params], [jnp.asarray(a) for a in params]
    st, jst = opt.init(p), jopt.init(jp)
    for _ in range(5):
        g = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
        p, st = opt.update(p, [torch.from_numpy(a) for a in g], st)
        jp, jst = jopt.update(jp, [jnp.asarray(a) for a in g], jst)
    for a, b in zip(p, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for mv, jmv in zip(st["mu"], jst["mu"]):
        assert isinstance(mv["m"], QTensor) == isinstance(jmv["m"], JaxQTensor)
        for k in ("m", "v"):
            if isinstance(mv[k], QTensor):
                np.testing.assert_array_equal(mv[k].q.numpy(), np.asarray(jmv[k].q))
                np.testing.assert_array_equal(mv[k].scale.numpy(), np.asarray(jmv[k].scale))
            else:
                np.testing.assert_array_equal(mv[k].float().numpy(), np.asarray(jmv[k]).astype(np.float32))
    assert isinstance(st["mu"][-1]["m"], QTensor) == (dtype == "int8")


# ---------------------------------------------------------------------------
# One training step against the JAX step
# ---------------------------------------------------------------------------


def test_train_step_matches_jax(pipeline_run):
    """The same params, standardiser and minibatch indices: the MSE, the
    gradient through the tanh GELU and one AdamW update within 1e-5."""
    theta = np.asarray(pipeline_run.fit.embedding, np.float32)
    x = pipeline_run.store.materialize()
    mu, sd = theta.mean(0), np.maximum(theta.std(0), 1e-6)
    dims = [2, 32, 16, x.shape[1]]
    rng = np.random.default_rng(1)
    ws = [(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32) for a, b in zip(dims, dims[1:])]
    bs = [rng.normal(size=(b,)).astype(np.float32) * 0.01 for b in dims[1:]]
    idx = rng.integers(0, theta.shape[0], 64)

    sched = dict(lr0=3e-3, warmup=30, total_steps=300)
    jopt = JaxAdamW(schedule=jax_warmup_cosine(**sched), weight_decay=1e-4, moment_dtype="float32")
    jp = {"w": [jnp.asarray(w) for w in ws], "b": [jnp.asarray(b) for b in bs]}

    def loss_fn(p):
        full = {"w": p["w"], "b": p["b"], "mu": jnp.asarray(mu), "sd": jnp.asarray(sd)}
        pred = jax_inverse._mlp_apply(full, jnp.asarray(theta[idx]))
        return jnp.mean(jnp.square(pred - jnp.asarray(x[idx])))

    jloss, g = jax.value_and_grad(loss_fn)(jp)
    jnew, _ = jopt.update(jp, g, jopt.init(jp))

    opt = AdamW(schedule=warmup_cosine(**sched), weight_decay=1e-4)
    params = [torch.from_numpy(a) for pair in zip(ws, bs) for a in pair]
    new, state, loss = train_step(params, opt.init(params), opt, torch.from_numpy(theta[idx]),
                                  torch.from_numpy(x[idx]), torch.from_numpy(mu), torch.from_numpy(sd))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for i in range(len(ws)):
        np.testing.assert_allclose(new[2 * i].numpy(), np.asarray(jnew["w"][i]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(new[2 * i + 1].numpy(), np.asarray(jnew["b"][i]), rtol=1e-5, atol=1e-5)
    assert state["count"] == 1


# ---------------------------------------------------------------------------
# The head: files both ways, determinism, quality
# ---------------------------------------------------------------------------


COORDS = np.asarray([[0.0, 0.0], [1.5, -2.0], [-3.0, 0.25], [10.0, 7.0]], np.float32)


def test_jax_head_loads_and_decodes_within_1e5(pipeline_run):
    jinv = pipeline_run.inverse
    inv = load_inverse(pipeline_run.checkpoint_dir)
    assert inv.hidden == jinv.hidden and inv.seed == jinv.seed and inv.train_steps == jinv.train_steps
    theta = np.concatenate([COORDS, pipeline_run.fit.embedding[:60]]).astype(np.float32)
    np.testing.assert_allclose(inv.decode(theta, device="cpu"), jinv.decode(theta), rtol=1e-5, atol=1e-5)


def test_port_head_loads_in_jax_bit_equal(port_frozen, tmp_path):
    inv = inverse_from_frozen(port_frozen, hidden=(24,), steps=40, seed=3, batch=64)
    path = save_inverse(str(tmp_path), inv)
    assert path == inverse_path(str(tmp_path))
    jinv = jax_inverse.load_inverse(str(tmp_path))
    for (w, b), (jw, jb) in zip(inv.layers, jinv.layers):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(inv.mu_in, jinv.mu_in)
    np.testing.assert_array_equal(inv.sd_in, jinv.sd_in)
    assert (jinv.seed, jinv.train_steps, jinv.train_loss) == (3, 40, inv.train_loss)
    np.testing.assert_allclose(inv.decode(COORDS, device="cpu"), jinv.decode(COORDS), rtol=1e-5, atol=1e-5)
    back = load_inverse(str(tmp_path))
    np.testing.assert_array_equal(back.decode(COORDS, device="cpu"), inv.decode(COORDS, device="cpu"))


def test_head_is_deterministic_per_seed(port_frozen):
    a = inverse_from_frozen(port_frozen, hidden=(32,), steps=50, seed=7)
    b = inverse_from_frozen(port_frozen, hidden=(32,), steps=50, seed=7)
    c = inverse_from_frozen(port_frozen, hidden=(32,), steps=50, seed=8)
    for (wa, ba), (wb, bb) in zip(a.layers, b.layers):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ba, bb)
    assert a.train_loss == b.train_loss
    assert any(not np.array_equal(wa, wc) for (wa, _), (wc, _) in zip(a.layers, c.layers))


def test_inverse_from_frozen_equals_train_inverse_of_corpus_order(pipeline_run, port_frozen):
    """The frozen map's gather path trains the head that train_inverse
    trains on the unpermuted (θ, x) arrays, bit for bit."""
    a = inverse_from_frozen(port_frozen, hidden=(16,), steps=30, seed=2, batch=32)
    b = train_inverse(pipeline_run.fit.embedding, pipeline_run.store.materialize(), hidden=(16,), steps=30,
                      seed=2, batch=32, device="cpu")
    for (wa, ba), (wb, bb) in zip(a.layers, b.layers):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ba, bb)
    np.testing.assert_array_equal(a.mu_in, b.mu_in)
    np.testing.assert_array_equal(a.sd_in, b.sd_in)


def test_standardiser_matches_jax(pipeline_run, port_frozen):
    inv = inverse_from_frozen(port_frozen, hidden=(8,), steps=1, seed=0)
    jinv = pipeline_run.inverse
    np.testing.assert_array_equal(inv.mu_in, jinv.mu_in)
    np.testing.assert_array_equal(inv.sd_in, jinv.sd_in)


def test_roundtrip_clears_floor(pipeline_run):
    theta, x = pipeline_run.fit.embedding, pipeline_run.store.materialize()
    inv = train_inverse(theta, x, steps=300, device="cpu")
    score = roundtrip_score(inv, theta, x, device="cpu")
    assert score >= ROUNDTRIP_R2_FLOOR, f"port head's round-trip R² {score:.3f} under {ROUNDTRIP_R2_FLOOR}"
    # the JAX function scores the port's head alike
    jhead = jax_inverse.InverseProjection(layers=inv.layers, mu_in=inv.mu_in, sd_in=inv.sd_in)
    assert score == pytest.approx(jax_inverse.roundtrip_score(jhead, theta, x), abs=1e-5)


def test_load_missing_is_actionable(tmp_path):
    assert load_inverse(str(tmp_path), missing_ok=True) is None
    with pytest.raises(FileNotFoundError, match="train_inverse"):
        load_inverse(str(tmp_path))


def test_decode_validates(pipeline_run):
    inv = load_inverse(pipeline_run.checkpoint_dir)
    with pytest.raises(ValueError, match="expected"):
        inv.decode(np.zeros((3, 5), np.float32), device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        inv.decode(np.asarray([[np.nan, 0.0]], np.float32), device="cpu")
    assert inv.decode(COORDS[0], device="cpu").shape == (1, inv.out_dim)


def test_train_inverse_validates_pairs():
    with pytest.raises(ValueError, match="matched"):
        train_inverse(np.zeros((5, 2), np.float32), np.zeros((6, 8), np.float32), device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        train_inverse(np.zeros((1, 2), np.float32), np.zeros((1, 8), np.float32), device="cpu")


# ---------------------------------------------------------------------------
# explore: the service's inverse path
# ---------------------------------------------------------------------------


def test_explore_matches_jax(pipeline_run):
    """One checkpoint with its JAX-trained head, served by both services:
    equal ids, embeddings and distances within 1e-5."""
    theta = np.concatenate([COORDS, pipeline_run.fit.embedding[:12]]).astype(np.float32)
    jsvc, psvc = JaxMapService(), MapService(device="cpu")
    try:
        jsvc.registry.load(pipeline_run.checkpoint_dir)
        h = psvc.registry.load(pipeline_run.checkpoint_dir)
        assert h.describe()["has_inverse"] is True
        want = jsvc.explore(theta, k=5)
        got = psvc.explore(theta, k=5)
        np.testing.assert_array_equal(got.neighbor_ids, want.neighbor_ids)
        np.testing.assert_allclose(got.embedding, want.embedding, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.neighbor_dists, want.neighbor_dists, rtol=1e-5, atol=1e-5)
        assert (got.map_version, got.map_fingerprint) == (want.map_version, want.map_fingerprint)
        assert got.neighbor_ids.dtype == np.int32
    finally:
        jsvc.close()
        psvc.close()


def test_explore_equals_neighbors_of_decode(pipeline_run, port_frozen):
    inv = inverse_from_frozen(port_frozen, hidden=(32,), steps=60, seed=1)
    svc = MapService(device="cpu")
    try:
        handle = svc.registry.add(port_frozen, inverse=inv, version="head")
        out = svc.explore(pipeline_run.fit.embedding[:16], k=4)
        dec = inv.decode(pipeline_run.fit.embedding[:16], device="cpu")
        np.testing.assert_array_equal(out.embedding, dec)
        ids, dists = port_frozen.neighbors(dec, k=4)
        np.testing.assert_array_equal(out.neighbor_ids, ids)
        np.testing.assert_array_equal(out.neighbor_dists, dists)
        assert out.map_version == "head" and out.map_fingerprint == handle.fingerprint
        one = svc.explore([0.5, -0.5])  # a 1-D coordinate, the map's k
        assert one.neighbor_ids.shape == (1, port_frozen.cfg.n_neighbors)
        assert svc.metrics.count("explore.served") == 2
    finally:
        svc.close()


def test_explore_without_inverse_is_actionable(port_frozen):
    svc = MapService(device="cpu")
    try:
        svc.registry.add(port_frozen)  # in-process add: no head
        assert svc.registry.get().describe()["has_inverse"] is False
        with pytest.raises(ValueError, match="inverse head"):
            svc.explore([0.0, 0.0])
    finally:
        svc.close()


def test_swap_carries_the_head(pipeline_run, port_frozen, tmp_path):
    """A checkpoint directory with a port-saved head: ``swap`` picks it up."""
    import shutil

    ck = str(tmp_path / "ck")
    shutil.copytree(pipeline_run.checkpoint_dir, ck)
    inv = inverse_from_frozen(port_frozen, hidden=(16,), steps=20, seed=4)
    save_inverse(ck, inv)
    svc = MapService(device="cpu")
    try:
        svc.registry.add(port_frozen, version="old")
        h = svc.registry.swap(ck, version="new")
        assert isinstance(h.inverse, InverseProjection) and svc.registry.active_version == "new"
        out = svc.explore(COORDS)
        np.testing.assert_array_equal(out.embedding, inv.decode(COORDS, device="cpu"))
        assert [d["version"] for d in svc.registry.versions()] == ["new"]
    finally:
        svc.close()
