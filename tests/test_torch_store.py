"""The port's on-disk embedding stores on the CPU: the JAX package's format
both ways (bf16 bytes included), chunked and gathered reads, meta
validation, ``as_store`` dispatch, the command line, ``prepare_inputs``'s
store gates and ``data_fingerprint``, each held to the JAX package's."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402  (the JAX package's bf16 dependency; the port has none)

from repro.core.nomad import prepare_inputs as jax_prepare_inputs  # noqa: E402
from repro.data import store as jst  # noqa: E402
from repro.data.synthetic import gaussian_mixture_store as jax_gaussian_mixture_store  # noqa: E402
from repro.index.ann import data_fingerprint as jax_data_fingerprint  # noqa: E402
from repro_torch.core.nomad import prepare_inputs  # noqa: E402
from repro_torch.data import store as pst  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture, gaussian_mixture_store  # noqa: E402
from repro_torch.index.ann import data_fingerprint  # noqa: E402

N, D = 1000, 12


@pytest.fixture(scope="module")
def x():
    return gaussian_mixture(N, D, n_components=5, seed=3)[0]


def _shards(directory):
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    return meta, [np.load(os.path.join(directory, name)) for name in meta["shards"]]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_formats_both_ways(x, tmp_path, dtype):
    """A JAX-written store reads bit for bit through the port and the
    reverse; the two writers' meta.json and shard files are identical."""
    a = jst.write_sharded(x, str(tmp_path / "jax"), rows_per_shard=300, dtype=dtype)
    b = pst.write_sharded(x, str(tmp_path / "port"), rows_per_shard=300, dtype=dtype)
    ma, sa = _shards(a.path)
    mb, sb = _shards(b.path)
    assert ma == mb
    for u, v in zip(sa, sb):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    want = a.materialize()
    np.testing.assert_array_equal(pst.ShardedStore(a.path).materialize(), want)
    np.testing.assert_array_equal(jst.ShardedStore(b.path).materialize(), want)
    assert pst.ShardedStore(a.path).dtype_name == dtype


def test_bf16_bytes_match_ml_dtypes():
    """Round to nearest even (ties both ways), subnormals, overflow to Inf,
    signed zeros and NaN: the port's bit arithmetic gives the bytes
    ml_dtypes gives, and decodes them back exactly."""
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF, 0x3F808001, 0x00008000,
                     0x00018000, 0x7F7FFFFF, 0x7F7F8000, 0xFF7F8000, 0x00000001, 0x80000001,
                     0x007FFFFF, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFFA12345, 0x80000000, 0],
                    np.uint32).view(np.float32)
    rng = np.random.default_rng(0)
    rand = np.concatenate([rng.normal(0, 10.0 ** e, 4096) for e in (-42, -39, -3, 0, 30)]).astype(np.float32)
    f = np.concatenate([ties, rand])
    with np.errstate(invalid="ignore"):
        want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = pst.bf16_bits(f)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pst.bf16_decode(got).view(np.uint32),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("chunk_rows", [1, 7, 300, 333, N + 5])
def test_ragged_chunk_reads(x, tmp_path, chunk_rows):
    """iter_chunks and stream_chunks cover the rows in order with a ragged
    tail, across shard boundaries, whatever the shard layout."""
    st = pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=128)
    chunks = list(st.iter_chunks(chunk_rows))
    assert [s for s, _ in chunks] == list(range(0, N, chunk_rows))
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]), x)
    streamed = list(pst.stream_chunks(st, chunk_rows))
    assert [s for s, _ in streamed] == [s for s, _ in chunks]
    for (_, u), (_, v) in zip(streamed, chunks):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(st.read(127, 257), x[127:257])
    assert st.read(5, 5).shape == (0, D)
    with pytest.raises(IndexError):
        st.read(0, N + 1)


def test_read_rows(x, tmp_path):
    """Unsorted, repeated rows gather the same from every container (the
    sharded store in one sorted pass, each shard loaded once)."""
    rows = np.random.default_rng(1).integers(0, N, 400)
    rows[:3] = [999, 0, 999]
    np.save(str(tmp_path / "x.npy"), x)
    stores = [pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=77),
              pst.MemmapStore(str(tmp_path / "x.npy")), pst.ArrayStore(x)]
    for st in stores:
        np.testing.assert_array_equal(st.read_rows(rows), x[rows])
    loads = []
    sharded = stores[0]
    real = sharded._shard
    sharded._cache = (-1, None)
    sharded._shard = lambda i: loads.append(i) or real(i)
    sharded.read_rows(rows)
    assert loads == sorted(set(loads))  # each shard once, in order
    np.testing.assert_array_equal(pst.EmbeddingStore.read_rows(sharded, rows), x[rows])
    with pytest.raises(IndexError):
        sharded.read_rows(np.array([N]))


def _corrupt(directory, how):
    meta_path = os.path.join(directory, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    if how == "no_meta":
        os.remove(meta_path)
        return
    if how == "format":
        meta["format"] = "something-else"
    elif how == "dtype":
        meta["dtype"] = "int8"
    elif how == "zero_row_shard":
        meta["shard_rows"][0], meta["shard_rows"][1] = 0, meta["shard_rows"][0] + meta["shard_rows"][1]
    elif how == "row_total":
        meta["n_rows"] += 1
    elif how == "shard_list":
        meta["shards"] = meta["shards"][:-1]
    elif how == "shard_shape":
        np.save(os.path.join(directory, meta["shards"][0]), np.zeros((3, D), np.float32))
    with open(meta_path, "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("how", ["no_meta", "format", "dtype", "zero_row_shard", "row_total",
                                 "shard_list", "shard_shape"])
def test_meta_validation(x, tmp_path, how):
    """Both packages refuse the same malformed stores with the same error."""
    directory = str(tmp_path / "s")
    pst.write_sharded(x, directory, rows_per_shard=300)
    _corrupt(directory, how)
    errors = []
    for mod in (jst, pst):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            mod.ShardedStore(directory).materialize()
        errors.append(e.type)
    assert errors[0] is errors[1]


def test_as_store_dispatch(x, tmp_path):
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=300)
    mm = np.load(path, mmap_mode="r")
    assert isinstance(pst.as_store(x), pst.ArrayStore) and pst.as_store(x).path is None
    assert isinstance(pst.as_store(mm), pst.ArrayStore) and pst.as_store(mm).path == mm.filename
    assert isinstance(pst.as_store(path), pst.MemmapStore)
    assert isinstance(pst.as_store(tmp_path / "s"), pst.ShardedStore)
    st = pst.as_store(path)
    assert pst.as_store(st) is st and pst.is_store(st) and not pst.is_store(x)
    with pytest.raises(FileNotFoundError):
        pst.as_store(str(tmp_path))  # a directory without meta.json
    with pytest.raises(ValueError, match=".npy"):
        pst.as_store(str(tmp_path / "s" / "meta.json"))
    with pytest.raises(TypeError):
        pst.as_store(3)
    np.save(str(tmp_path / "v.npy"), np.zeros((4, 2), ml_dtypes.bfloat16))
    with pytest.raises(ValueError, match="void"):
        pst.as_store(str(tmp_path / "v.npy"))
    with pytest.raises(ValueError, match="2-D"):
        pst.ArrayStore(np.zeros(5, np.float32))


def test_cli_convert_and_info(x, tmp_path, capsys):
    src = str(tmp_path / "x.npy")
    np.save(src, x)
    out = str(tmp_path / "converted")
    assert pst.main(["convert", src, out, "--rows-per-shard", "300", "--dtype", "bfloat16"]) == 0
    said = capsys.readouterr().out
    assert f"{N} rows x {D} dims" in said and "4 shard(s)" in said
    ref = jst.write_sharded(jst.as_store(src), str(tmp_path / "ref"), rows_per_shard=300, dtype="bfloat16")
    for u, v in zip(_shards(out)[1], _shards(ref.path)[1]):
        assert u.tobytes() == v.tobytes()
    assert pst.main(["info", out]) == 0
    said = capsys.readouterr().out
    assert "ShardedStore" in said and "bfloat16" in said and "[300, 300, 300, 100]" in said
    assert pst.main(["info", src]) == 0
    assert "MemmapStore" in capsys.readouterr().out


def test_write_sharded_several_writers(x, tmp_path):
    """Two writers each own a shard-aligned range; one commit makes the
    store the single writer makes. Misaligned ranges are refused."""
    out = str(tmp_path / "multi")
    assert pst.write_sharded(x[:600], out, rows_per_shard=200, total_rows=N, commit=False) is None
    pst.write_sharded(x[600:], out, rows_per_shard=200, row_offset=600, total_rows=N, commit=False)
    st = pst.commit_sharded_meta(out, N, D, rows_per_shard=200)
    np.testing.assert_array_equal(st.materialize(), x)
    with pytest.raises(ValueError, match="two writers"):
        pst.write_sharded(x[:100], str(tmp_path / "bad"), rows_per_shard=200, row_offset=100, total_rows=N)
    with pytest.raises(FileNotFoundError):
        pst.commit_sharded_meta(str(tmp_path / "multi2"), N, D, rows_per_shard=200)
    with pytest.raises(ValueError, match="no rows"):
        pst.write_sharded(iter([]), str(tmp_path / "empty"))


def test_copy_to_npy(x, tmp_path):
    st = pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=300, dtype="float16")
    path = pst.copy_to_npy(st, str(tmp_path / "c.npy"), chunk_rows=128)
    np.testing.assert_array_equal(np.load(path), st.materialize())


def test_prepare_inputs_store_gates(x, tmp_path):
    """The same stores pass, and fail with the same words, in both
    packages; a memmap is validated chunk by chunk and returned as a store."""
    good = pst.write_sharded(x, str(tmp_path / "good"), rows_per_shard=300)
    assert prepare_inputs(good) is good
    bad = x.copy()
    bad[3, 1], bad[700, 0] = np.nan, np.inf
    np.save(str(tmp_path / "bad.npy"), bad)
    np.save(str(tmp_path / "f64.npy"), x.astype(np.float64))
    pst.write_sharded(bad, str(tmp_path / "bad_store"), rows_per_shard=300)
    cases = [
        (str(tmp_path / "bad.npy"), {}),
        (str(tmp_path / "bad_store"), {"chunk_rows": 128}),
        (str(tmp_path / "f64.npy"), {}),
        (good.path, {"dim": D + 1, "caller": "transform"}),
    ]
    for src, kw in cases:
        with pytest.raises(ValueError) as mine:
            prepare_inputs(src, **kw)
        with pytest.raises(ValueError) as theirs:
            jax_prepare_inputs(src, **kw)
        assert str(mine.value) == str(theirs.value)
    mm = np.load(str(tmp_path / "bad.npy"), mmap_mode="r")
    with pytest.raises(ValueError, match="2 non-finite"):
        prepare_inputs(mm)
    np.save(str(tmp_path / "x16.npy"), x.astype(np.float16))
    out = prepare_inputs(np.load(str(tmp_path / "x16.npy"), mmap_mode="r"), chunk_rows=64)
    assert pst.is_store(out) and out.read(0, 10).dtype == np.float32
    np.testing.assert_array_equal(out.read(0, 10), x[:10].astype(np.float16).astype(np.float32))


def test_stream_chunks_surfaces_read_error(x, tmp_path):
    """A read that fails on the prefetch thread raises in the consumer."""
    st = pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=300)
    os.remove(os.path.join(st.path, "shard-00002.npy"))
    got = []
    with pytest.raises(FileNotFoundError):
        for s, _chunk in pst.stream_chunks(st, 250):
            got.append(s)
    assert got == [0, 250]


@pytest.mark.parametrize("block_rows", [65536, 128])
def test_data_fingerprint_every_container(x, tmp_path, block_rows):
    """The same rows hash the same in every container, in both packages;
    one changed value changes the hash."""
    np.save(str(tmp_path / "x.npy"), x)
    st = pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=333)
    want = jax_data_fingerprint(x, block_rows=block_rows)
    for c in (x, np.load(str(tmp_path / "x.npy"), mmap_mode="r"), st, pst.MemmapStore(str(tmp_path / "x.npy")),
              pst.ArrayStore(x)):
        assert data_fingerprint(c, block_rows=block_rows) == want
    assert jax_data_fingerprint(jst.ShardedStore(st.path), block_rows=block_rows) == want
    y = x.copy()
    y[500, 2] += 1e-3
    assert data_fingerprint(y, block_rows=block_rows) != want


def test_gaussian_mixture_store_matches(tmp_path):
    """The chunked generator writes gaussian_mixture's rows, and the JAX
    package's generator writes the same store."""
    x, lab = gaussian_mixture(1200, 10, n_components=5, seed=11)
    st, lab2 = gaussian_mixture_store(str(tmp_path / "g"), 1200, 10, n_components=5, seed=11,
                                      chunk_rows=301, rows_per_shard=512, dtype="bfloat16")
    ref, lab3 = jax_gaussian_mixture_store(str(tmp_path / "r"), 1200, 10, n_components=5, seed=11,
                                           chunk_rows=301, rows_per_shard=512, dtype="bfloat16")
    np.testing.assert_array_equal(lab, lab2)
    np.testing.assert_array_equal(lab, lab3)
    np.testing.assert_array_equal(st.materialize(), pst.bf16_decode(pst.bf16_bits(x)))
    np.testing.assert_array_equal(st.materialize(), ref.materialize())


def test_read_encoded_widens_on_the_device_as_on_the_host(x, tmp_path):
    """A bf16 store's encoded rows are its stored bits; widened by
    ``chunk_to_device`` they equal the host's decode bit for bit, for every
    one of the 65,536 patterns. Other dtypes read as read() does."""
    from repro_torch.index.kmeans import chunk_to_device

    st = pst.write_sharded(x, str(tmp_path / "b"), rows_per_shard=300, dtype="bfloat16")
    raw = st.read_encoded(250, 700)
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(pst.bf16_decode(raw), st.read(250, 700))
    every = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    np.testing.assert_array_equal(chunk_to_device(every, "cpu").numpy().view(np.uint32),
                                  pst.bf16_decode(every).view(np.uint32))
    f16 = pst.write_sharded(x, str(tmp_path / "h"), rows_per_shard=300, dtype="float16")
    np.testing.assert_array_equal(f16.read_encoded(0, 10), f16.read(0, 10))
    assert [s for s, _ in pst.stream_chunks(st, 400, encoded=True)] == [0, 400, 800]
