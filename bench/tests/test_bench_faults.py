"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven as it is.
One test a fault the cell can have (one card: no exchange between chips)."""

import numpy as np
import pytest
import torch

from bench.tests import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root.make(tmp_path_factory.mktemp("checkout"))


def _failed(out):
    assert out["correct"] is False, out["checks"]
    return {n for n, c in out["checks"].items() if not c["value"] <= c["limit"]}


def test_train_step_returns_state_unchanged(root, monkeypatch):
    from repro_torch.core import nomad

    orig = nomad.step_update

    def unchanged(theta, *args, **kw):
        saved = theta.clone()
        loss = orig(theta, *args, **kw)
        theta.copy_(saved)
        return loss

    monkeypatch.setattr(nomad, "step_update", unchanged)
    assert "change_gap" in _failed(tiny_root.run(root, "tiny.train")[0])


def test_train_half_the_batch_left_out(root, monkeypatch):
    from repro_torch.core import nomad

    orig = nomad.step_update

    def half(theta, idx, means, counts_f, lr, rows, cl, neg_rows, **kw):
        h = rows.shape[0] // 2
        return orig(theta, idx, means, counts_f, lr, rows[:h], cl[:h], neg_rows[:h], **kw)

    monkeypatch.setattr(nomad, "step_update", half)
    assert _failed(tiny_root.run(root, "tiny.train")[0]) & {"loss_gap", "change_gap"}


def test_train_epoch_skips_half_its_steps(root, monkeypatch):
    from repro_torch.core import strategy

    orig = strategy.LocalStrategy.run_epoch

    def half(self, *args):
        steps, self.steps = self.steps, max(1, self.steps // 2)
        try:
            return orig(self, *args)
        finally:
            self.steps = steps

    monkeypatch.setattr(strategy.LocalStrategy, "run_epoch", half)
    assert "change_gap" in _failed(tiny_root.run(root, "tiny.train")[0])


def test_kmeans_returns_its_seeding(root, monkeypatch):
    from repro_torch.index import kmeans

    orig = kmeans.kmeans_centroids_streamed

    def seeding(*args, n_iters=25, **kw):
        return orig(*args, n_iters=0, **kw)

    monkeypatch.setattr(kmeans, "kmeans_centroids_streamed", seeding)
    assert "kmeans_gap" in _failed(tiny_root.run(root, "tiny.train")[0])


def test_kmeans_estep_argmin_altered(root, monkeypatch):
    from repro_torch.index import kmeans

    orig = kmeans.blocked_assign

    def evens(x, cents, block):  # the nearest of every other centroid
        a, d = orig(x, cents[::2], block)
        return a * 2, d

    monkeypatch.setattr(kmeans, "blocked_assign", evens)
    assert "kmeans_gap" in _failed(tiny_root.run(root, "tiny.train")[0])


def test_build_answer_altered(root, monkeypatch):
    from repro_torch.index import build

    orig = build.finalize_knn

    def altered(knn_local, knn_w, K, C):
        knn_local = knn_local.copy()
        w = knn_w.reshape(K, C, -1)
        cell, row = 0, 0
        far = int(np.argmax(np.abs(np.arange(C) - row)[: max(2, int((w[cell] > 0).any(-1).sum()))]))
        knn_local[cell, row, 0] = far
        return orig(knn_local, knn_w, K, C)

    monkeypatch.setattr(build, "finalize_knn", altered)
    assert _failed(tiny_root.run(root, "tiny.build")[0]) & {"knn_gap", "knn_w_gap", "layout"}


def test_serve_answer_altered(root, monkeypatch):
    from repro_torch.serve import server

    orig = server.place_batch

    def altered(*args, **kw):
        theta, *rest = orig(*args, **kw)
        theta = theta.clone()
        theta[0] += 1.0
        return (theta, *rest)

    monkeypatch.setattr(server, "place_batch", altered)
    assert "place_gap" in _failed(tiny_root.run(root, "tiny.serve")[0])


def test_serve_step_returns_state_unchanged(root, monkeypatch):
    from repro_torch.serve import transform

    def unchanged(theta, *args, **kw):
        return theta, torch.zeros(())

    monkeypatch.setattr(transform, "frozen_step", unchanged)
    assert "place_gap" in _failed(tiny_root.run(root, "tiny.serve")[0])


def test_serve_half_the_batch_left_out(root, monkeypatch):
    from repro_torch.serve import transform

    orig = transform.frozen_step

    def half(theta, fz, own, nb_theta, nb_w, nslot, valid, lr_t):
        h = theta.shape[0] // 2
        moved, loss = orig(theta, fz, own, nb_theta, nb_w, nslot, valid, lr_t)
        return torch.cat([moved[:h], theta[h:]]), loss

    monkeypatch.setattr(transform, "frozen_step", half)
    assert "place_gap" in _failed(tiny_root.run(root, "tiny.serve")[0])
