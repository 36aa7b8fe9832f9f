"""The port's embed pipeline (``repro_torch.pipeline``: ``embed_chunks``,
``embed_to_store``, ``run_pipeline``) on the CPU, mirroring
``tests/test_pipeline.py`` at its ``tiny(...)`` sizes for the three
registered families (dense, SSM, MoE), and against the JAX package's
``embed_corpus`` on the same converted weights and tokens.

Tolerance of pooled vectors against the JAX package: rtol = atol = 1e-4
(float32 forwards; the mean over S adds nothing measurable). Inside the
port, streamed ≡ materialized and the stores' bytes are compared bit for
bit.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import PIPELINE_WORKLOADS as REF_WORKLOADS  # noqa: E402
from repro.data.embeddings import embed_corpus as ref_embed_corpus  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import PIPELINE_WORKLOADS  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.data.embeddings import embed_corpus  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.pipeline import (  # noqa: E402
    corpus_for,
    embed_chunks,
    embed_to_store,
    init_embedder,
    make_embed_fn,
    run_pipeline,
)
from repro_torch.pipeline.embed import embed_dim, n_embed_batches  # noqa: E402
from repro_torch.service import MapService  # noqa: E402

# the JAX package's committed floor for the round-trip R² (tests/test_pipeline.py)
ROUNDTRIP_R2_FLOOR = 0.15
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's forwards and fits here are tiny: one intra-op thread
    runs them faster than a pool, and keeps the module from contending
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name: str, workloads=PIPELINE_WORKLOADS):
    """A CI-sized copy of a registered workload (tests/test_pipeline.py's)."""
    return dataclasses.replace(workloads[name], n_docs=256, seq_len=32, doc_batch=64, n_epochs=2, n_clusters=8)


def _batches(tokens, doc_batch):
    return [tokens[i : i + doc_batch] for i in range(0, tokens.shape[0], doc_batch)]


def test_workloads_equal_reference():
    assert sorted(PIPELINE_WORKLOADS) == sorted(REF_WORKLOADS)
    for name, w in PIPELINE_WORKLOADS.items():
        ref = REF_WORKLOADS[name]
        assert dataclasses.asdict(w) == dataclasses.asdict(ref)
        assert dataclasses.asdict(w.arch_config()) == dataclasses.asdict(ref.arch_config())
        assert dataclasses.asdict(w.nomad_config(100, 32)) == {
            k: v for k, v in dataclasses.asdict(ref.nomad_config(100, 32)).items()
            if k not in ("kernel_impl", "use_pallas")}


@pytest.mark.parametrize("name", sorted(PIPELINE_WORKLOADS))
def test_pooled_vectors_match_reference(name):
    """The same tokens (the corpus drawn by both packages from one seed)
    through the JAX embedder and its converted copy, both poolings."""
    w = tiny(name)
    tokens, classes = corpus_for(w)
    from repro.pipeline.embed import corpus_for as ref_corpus_for

    ref_tokens, ref_classes = ref_corpus_for(tiny(name, REF_WORKLOADS))
    np.testing.assert_array_equal(tokens, ref_tokens)
    np.testing.assert_array_equal(classes, ref_classes)
    ref_cfg = REF_WORKLOADS[name].arch_config()
    params = ref_lm.init_params(jax.random.key(0), ref_cfg)
    model = convert.from_reference(jax.tree.map(np.asarray, params), w.arch_config(), device="cpu")
    for pool in ("mean", "last"):
        want = ref_embed_corpus(params, ref_cfg, _batches(tokens, w.doc_batch), pool=pool)
        got = embed_corpus(model, w.arch_config(), _batches(tokens, w.doc_batch), pool=pool)
        assert got.dtype == np.float32 and got.shape == (w.n_docs, embed_dim(w.arch_config()))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(PIPELINE_WORKLOADS))
def test_streamed_fit_bit_equals_materialized_fit(name, tmp_path):
    """Per family: the store holds embed_corpus's exact bytes, and the
    fit from it is the fit of the matrix, bit for bit. Shard size ≠
    doc_batch ≠ chunk_rows, so none of the three blockings may leak."""
    w = tiny(name)
    tokens, _ = corpus_for(w)
    params, acfg = init_embedder(w, device=CPU)
    store = embed_to_store(params, acfg, tokens, str(tmp_path / "st"), doc_batch=w.doc_batch, rows_per_shard=100)
    mat = embed_corpus(params, acfg, _batches(tokens, w.doc_batch))
    np.testing.assert_array_equal(store.materialize(), mat)
    cfg = w.nomad_config(w.n_docs, mat.shape[1], chunk_rows=64, seed=0)
    e_streamed = NomadProjection(cfg, device=CPU).fit(store).embedding
    e_materialized = NomadProjection(cfg, device=CPU).fit(mat).embedding
    np.testing.assert_array_equal(e_streamed, e_materialized)


def test_embed_chunks_matches_explicit_batches():
    w = tiny("pipeline_phi4_mini")
    tokens, _ = corpus_for(w)
    params, acfg = init_embedder(w, device=CPU)
    auto = list(embed_chunks(params, acfg, tokens, doc_batch=w.doc_batch))
    explicit = list(embed_chunks(params, acfg, _batches(tokens, w.doc_batch)))
    assert len(auto) == len(explicit) == n_embed_batches(w.n_docs, w.doc_batch)
    for a, b in zip(auto, explicit):
        np.testing.assert_array_equal(a, b)


def test_embed_worker_error_reraises_in_consumer(tmp_path):
    """A poisoned forward (3-D tokens) fails the consumer with the worker's
    exception and commits no store."""
    w = tiny("pipeline_phi4_mini")
    params, acfg = init_embedder(w, device=CPU)
    bad = [np.zeros((4, 8, 3), np.int32)]
    with pytest.raises(Exception):
        list(embed_chunks(params, acfg, bad))
    out = str(tmp_path / "st")
    with pytest.raises(Exception):
        embed_to_store(params, acfg, bad, out)
    assert not os.path.exists(os.path.join(out, "meta.json"))
    with pytest.raises(ValueError, match="pool"):
        make_embed_fn(acfg, "max")


def test_init_embedder_is_seeded_and_needs_a_device():
    w = tiny("pipeline_mixtral_8x7b")
    a, _ = init_embedder(w, seed=3, device=CPU)
    b, _ = init_embedder(w, seed=3, device=CPU)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if torch.cuda.is_available():
        return  # the default device exists here; the refusal needs a CPU-only host
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_embedder(w)


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    w = tiny("pipeline_phi4_mini")
    d = str(tmp_path_factory.mktemp("pipeline"))
    return run_pipeline(w, d, inverse_steps=300, nomad_overrides={"n_epochs": 4}, device=CPU)


def test_run_pipeline_artifacts(pipeline_run):
    r = pipeline_run
    assert r.store.shape == (r.workload.n_docs, r.workload.d_model)
    assert set(r.stage_s) == {"embed", "fit", "inverse_train"}
    for f in ("index.npz", "inverse.npz"):
        assert os.path.exists(os.path.join(r.checkpoint_dir, f))
    assert os.path.exists(os.path.join(os.path.dirname(r.checkpoint_dir), "embeddings", "meta.json"))
    assert r.roundtrip_score >= ROUNDTRIP_R2_FLOOR
    assert r.fit.embedding.shape == (r.workload.n_docs, 2)


@pytest.mark.parametrize("name", ["pipeline_mamba2_2_7b", "pipeline_mixtral_8x7b"])
def test_run_pipeline_other_families(name, tmp_path):
    r = run_pipeline(tiny(name), str(tmp_path), inverse_steps=100, device=CPU)
    assert r.store.shape == (256, r.workload.d_model) and np.isfinite(r.fit.embedding).all()
    assert os.path.exists(os.path.join(r.checkpoint_dir, "inverse.npz"))


def test_registry_serves_the_pipeline_directory(pipeline_run):
    """``MapRegistry.load(map_dir)`` alone serves explore and project."""
    svc = MapService(device=CPU)
    try:
        handle = svc.registry.load(pipeline_run.checkpoint_dir)
        assert handle.describe()["has_inverse"] is True
        theta = pipeline_run.fit.embedding
        out = svc.explore(theta[:4], k=5)
        assert out.embedding.shape == (4, pipeline_run.frozen.dim)
        ids, dists = pipeline_run.frozen.neighbors(out.embedding, k=5)
        np.testing.assert_array_equal(ids, out.neighbor_ids)
        np.testing.assert_array_equal(dists, out.neighbor_dists)
        q = pipeline_run.store.materialize()[:8]
        assert np.isfinite(svc.project(q, seed=0).result.embedding).all()
    finally:
        svc.close()
