"""The port's ``TokenStream`` (``repro_torch.data.loader``) against the JAX
package's (``repro.data.loader``).

The reference seeds a batch with ``abs(hash((name, step, shard))) % 2**31``,
and Python salts a ``str``'s hash per process. The port seeds from the
integers alone (``stream_seed``). Everything after the seed is the
reference's, draw for draw: with the reference module's ``hash`` replaced by
the port's seed, its batch equals the port's exactly. The port's batches
are the same in processes with different ``PYTHONHASHSEED``; shards and
the learnable structure behave as ``tests/test_data.py`` asks of the
reference.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import repro.data.loader as ref_loader
from repro_torch.data.loader import TokenStream, stream_seed

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.mark.parametrize("name,step,shard,n_shards,vocab,seq",
                         [("train", 0, 0, 1, 1000, 64), ("train", 17, 3, 4, 50_280, 33), ("eval", 5, 0, 2, 100, 128)])
def test_batch_equals_reference_under_the_ports_seed(monkeypatch, name, step, shard, n_shards, vocab, seq):
    monkeypatch.setattr(ref_loader, "hash", lambda key: stream_seed(*key), raising=False)
    ours = TokenStream(vocab, seq, name=name).batch(step, 32, shard=shard, n_shards=n_shards)
    theirs = ref_loader.TokenStream(vocab, seq, name=name).batch(step, 32, shard=shard, n_shards=n_shards)
    assert ours.keys() == theirs.keys() == {"tokens", "labels"}
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_seed_is_stable_across_processes():
    """Two interpreters with different ``PYTHONHASHSEED`` draw the same
    batch (and the same seed as this process)."""
    code = ("import hashlib; from repro_torch.data.loader import TokenStream, stream_seed; "
            "b = TokenStream(1000, 32).batch(3, 8, shard=1, n_shards=2); "
            "print(stream_seed('train', 3, 1), hashlib.sha256(b['tokens'].tobytes()).hexdigest())")
    outs = []
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=salt, PYTHONPATH=SRC)
        outs.append(subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                                   check=True, timeout=120).stdout.split())
    import hashlib

    here = TokenStream(1000, 32).batch(3, 8, shard=1, n_shards=2)
    assert outs[0] == outs[1] == [str(stream_seed("train", 3, 1)), hashlib.sha256(here["tokens"].tobytes()).hexdigest()]
    assert 0 <= stream_seed("train", 3, 1) < 2**31


def test_determinism_and_shards():
    """``tests/test_data.py:test_loader_determinism_and_shards`` on the port."""
    ts = TokenStream(vocab_size=1000, seq_len=64)
    b1, b2 = ts.batch(step=5, batch_size=32), ts.batch(step=5, batch_size=32)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], ts.batch(step=6, batch_size=32)["tokens"])
    s0 = ts.batch(step=5, batch_size=32, shard=0, n_shards=4)
    s1 = ts.batch(step=5, batch_size=32, shard=1, n_shards=4)
    assert s0["tokens"].shape == (8, 64)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    assert not np.array_equal(TokenStream(1000, 64, name="eval").batch(5, 32)["tokens"], b1["tokens"])
    assert int(b1["tokens"].max()) < 1000 and int(b1["tokens"].min()) >= 0


def test_has_learnable_structure():
    """``tests/test_data.py:test_loader_has_learnable_structure``: every
    odd position repeats its predecessor about half the time."""
    b = TokenStream(vocab_size=100, seq_len=128).batch(step=0, batch_size=64)
    rep = (b["labels"][:, ::2] == b["tokens"][:, ::2]).mean()
    assert rep > 0.3
