"""The arithmetic of the 3xTF32 tile (``csrc/tf32x3_tile.cuh``), emulated in
numpy, against the JAX package's oracles; and the pure-Python planners of
K2 (centroid chunks) and K3 (route, block tile).

The card's kernels cannot run here, so the emulation repeats what they do:
each fp32 operand v is split into big = tf32(v) and small = tf32(v − big)
(round to 10 mantissa bits, ties away from zero, as ``cvt.rna``); every
8-deep k-step sums small·big, big·small and big·big, in that order, from
zero, each as one ``mma`` whose eight products are exact and whose sum is
truncated toward zero (the card's tensor cores truncate when they
accumulate); the k-step's sum is then added to the fp32 accumulator,
rounded to nearest. The row norms are summed in fp32 by the four lanes of
a quad (columns ≡ t mod 4, in k order) and added as (s0 + s1) + (s2 + s3);
the epilogue is max((‖x‖² + ‖y‖²) − 2·x·y, 0). The tolerances are the
port's own, unchanged: the JAX spec's (2e-5, 2e-5) for K3 and its oracle
rule at (1e-4, 1e-4) for K2 at the spec's check shapes, and
``pairwise/ops.py:allowed_error`` at D = 768, where fp32 rounding scales
with ‖x‖² + ‖y‖² rather than with the (small) distance. A single TF32 pass
must break that bound, which shows the emulation can fail.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops  # noqa: E402
from repro_torch.kernels.pairwise import ops as pairwise_ops  # noqa: E402

F32, F64 = np.float32, np.float64
SMS = 132  # an H100 SXM's streaming multiprocessors


def tf32(a: np.ndarray) -> np.ndarray:
    """fp32 → TF32 as ``cvt.rna.tf32.f32`` rounds: keep 10 mantissa bits,
    round half away from zero (add half of the dropped range to the
    magnitude bits, then truncate)."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _pad8(a: np.ndarray) -> np.ndarray:
    d = a.shape[1]
    out = np.zeros((a.shape[0], -(-d // 8) * 8), F32)
    out[:, :d] = a
    return out


def toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 → fp32, truncated toward zero."""
    r = v.astype(F32)
    over = np.abs(r.astype(F64)) > np.abs(v)
    r[over] = np.nextafter(r[over], F32(0))
    return r


def emulated_cross(x: np.ndarray, y: np.ndarray, passes: int = 3) -> np.ndarray:
    """x·yᵀ as the tile computes it: per 8-deep k-step, the mma terms in
    order from zero, each sum truncated; then the k-step's sum added to the
    accumulator, rounded to nearest."""
    xp, yp = _pad8(x), _pad8(y)
    xb, yb = tf32(xp), tf32(yp)
    xs, ys = tf32(xp - xb), tf32(yp - yb)
    terms = ((xs, yb), (xb, ys), (xb, yb)) if passes == 3 else ((xb, yb),)
    acc = np.zeros((x.shape[0], y.shape[0]), F32)
    for k0 in range(0, xp.shape[1], 8):
        p = np.zeros_like(acc)
        for a, b in terms:
            p = toward_zero(p.astype(F64) + a[:, k0 : k0 + 8].astype(F64) @ b[:, k0 : k0 + 8].astype(F64).T)
        acc = acc + p
    return acc


def emulated_sqnorm(a: np.ndarray) -> np.ndarray:
    """Row norms as the quad sums them: lane t takes columns k0+t, k0+t+4
    of each k-step with fmaf, then (s0 + s1) + (s2 + s3)."""
    ap = _pad8(a)
    s = np.zeros((ap.shape[0], 4), F32)
    for k0 in range(0, ap.shape[1], 8):
        for t in range(4):
            for c in (k0 + t, k0 + t + 4):
                s[:, t] = (s[:, t].astype(F64) + ap[:, c].astype(F64) ** 2).astype(F32)
    return (s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3])


def emulated_dist2(x, y, passes: int = 3) -> np.ndarray:
    x, y = np.asarray(x, F32), np.asarray(y, F32)
    d2 = (emulated_sqnorm(x)[:, None] + emulated_sqnorm(y)[None, :]) - F32(2) * emulated_cross(x, y, passes)
    return np.maximum(d2, F32(0))


def emulated_assign(x, c, chunk_cols: int | None = None):
    """K2: per chunk of centroids the first minimum, then the chunks in
    ascending order, a later one winning only when strictly smaller
    (``reduce_chunks_kernel``)."""
    d2 = emulated_dist2(x, c)
    k = d2.shape[1]
    step = chunk_cols or k
    best_i = best_v = None
    for c0 in range(0, k, step):
        part = d2[:, c0 : c0 + step]
        i = np.argmin(part, 1) + c0
        v = part[np.arange(len(i)), i - c0]
        if best_v is None:
            best_i, best_v = i, v
        else:
            take = v < best_v
            best_i, best_v = np.where(take, i, best_i), np.where(take, v, best_v)
    return best_i.astype(np.int32), best_v


def _spec_inputs(name: str, idx: int):
    """The JAX spec's check shape ``idx``: numpy normals rounded to the
    spec's dtype, as fp32."""
    sig = jax_registry.get(name).check_shapes[idx]
    rng = np.random.default_rng(100 + idx)
    return [np.asarray(jnp.asarray(rng.normal(size=s), getattr(jnp, dt)).astype(jnp.float32)) for s, dt in sig]


def _mixture_cell(rows: int = 305, dim: int = 768, seed: int = 0) -> np.ndarray:
    """One cell of the main path's data: a unit centre plus the mixture's
    noise (spread 0.15/√dim), so distances are far below ‖x‖² + ‖y‖²."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=dim)
    c /= np.linalg.norm(c)
    return (c + rng.normal(0, 0.15 / np.sqrt(dim), (rows, dim))).astype(F32)


def _allowed(x, y) -> np.ndarray:
    return pairwise_ops.allowed_error(torch.from_numpy(x), torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("idx", range(len(jax_registry.get("pairwise").check_shapes)))
def test_tile_pairwise_holds_spec_tolerance(idx):
    """K3 at every JAX check shape (d = 33 included): the spec's (2e-5, 2e-5)."""
    x, y = _spec_inputs("pairwise", idx)
    want = np.asarray(jax_registry.get("pairwise").ref(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(emulated_dist2(x, y), want, *pairwise_ops.SPEC_TOL)


@pytest.mark.parametrize("idx", range(len(jax_registry.get("kmeans_assign").check_shapes)))
def test_tile_assign_holds_oracle_check(idx):
    """K2 at every JAX check shape: the spec's oracle rule at (1e-4, 1e-4),
    and, split into 128-centroid chunks, the same result as unsplit."""
    x, c = _spec_inputs("kmeans_assign", idx)
    want = jax_registry.get("kmeans_assign").ref(jnp.asarray(x), jnp.asarray(c))
    got = emulated_assign(x, c)
    kmeans_ops.oracle_check(x, c, got, want)
    split = emulated_assign(x, c, chunk_cols=128)
    np.testing.assert_array_equal(split[0], got[0])
    np.testing.assert_array_equal(split[1], got[1])


@pytest.mark.parametrize("data", ["randn", "mixture_cell"])
def test_tile_pairwise_holds_allowed_error_at_768(data):
    """At D = 768, on randn rows and on a 305-row cell of the mixture, the
    3xTF32 distances stay within allowed_error of the JAX oracle; a single
    TF32 pass does not (the bound has teeth)."""
    if data == "randn":
        rng = np.random.default_rng(7)
        x, y = rng.normal(size=(256, 768)).astype(F32), rng.normal(size=(192, 768)).astype(F32)
    else:
        x = y = _mixture_cell()
    want = np.asarray(jax_registry.get("pairwise").ref(jnp.asarray(x), jnp.asarray(y)))
    bound = _allowed(x, y)
    assert np.all(np.abs(emulated_dist2(x, y) - want) <= bound)
    assert not np.all(np.abs(emulated_dist2(x, y, passes=1) - want) <= bound)


def test_one_truncating_chain_would_drift():
    """Why each k-step is summed from zero: with all 3·96 mma of D = 768
    truncating into one accumulator, a row's distance to itself drifts to
    a large share of allowed_error (the card showed half of it); summed per
    k-step and added rounded to nearest, it stays a small share."""
    x = np.random.default_rng(5).normal(size=(64, 768)).astype(F32)
    xb, xs = tf32(x), tf32(x - tf32(x))
    chain = np.zeros((64, 64), F32)
    for k0 in range(0, 768, 8):
        for a, b in ((xs, xb), (xb, xs), (xb, xb)):
            chain = toward_zero(chain.astype(F64) + a[:, k0 : k0 + 8].astype(F64) @ b[:, k0 : k0 + 8].astype(F64).T)
    norms = emulated_sqnorm(x)
    want = np.asarray(jax_registry.get("pairwise").ref(jnp.asarray(x), jnp.asarray(x)))
    share = lambda cross: np.max(  # noqa: E731
        np.abs(np.maximum((norms[:, None] + norms[None, :]) - F32(2) * cross, 0) - want) / _allowed(x, x))
    assert share(chain) > 0.25
    assert share(emulated_cross(x, x)) < 0.05


def test_tile_assign_at_768_matches_fp32_argmins():
    """K2 at D = 768: the oracle rule holds and every argmin equals the
    fp32 oracle's (randn rows against randn centroids are not near ties)."""
    rng = np.random.default_rng(11)
    x, c = rng.normal(size=(128, 768)).astype(F32), rng.normal(size=(300, 768)).astype(F32)
    want = jax_registry.get("kmeans_assign").ref(jnp.asarray(x), jnp.asarray(c))
    got = emulated_assign(x, c)
    kmeans_ops.oracle_check(x, c, got, want)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


def test_tied_centroids_across_chunks_keep_the_lower_index():
    """Duplicated centroids give bit-equal distances, and the chunked
    reduction keeps the lower index, in the first chunk and across chunks."""
    rng = np.random.default_rng(3)
    c = rng.normal(size=(600, 64)).astype(F32)
    c[300] = c[5]
    c[599] = c[0]
    x = np.concatenate([c[[5, 0]], c[[5, 0]] + 1e-3 * rng.normal(size=(2, 64))]).astype(F32)
    for chunk_cols in (None, 128, 256):
        arg, _ = emulated_assign(x, c, chunk_cols)
        np.testing.assert_array_equal(arg, [5, 0, 5, 0])


@pytest.mark.parametrize("n", [1, 512, 576, 1024, 16384])
def test_plan_chunks_cover_the_centroids(n):
    """The chunks are contiguous, ascending, a multiple of the tile wide,
    and cover K exactly once; a call that already fills the card is not
    split, and a small one is spread over most of the SMs."""
    k = 4096
    chunks, cols = kmeans_ops.plan(n, k, SMS)
    assert cols % kmeans_ops.TILE == 0 and chunks >= 1
    bounds = [(i * cols, min(k, (i + 1) * cols)) for i in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    row_blocks, col_tiles = -(-n // kmeans_ops.TILE), -(-k // kmeans_ops.TILE)
    if row_blocks * 2 > SMS:
        assert chunks == 1
    else:
        assert min(SMS // 2, row_blocks * col_tiles) <= row_blocks * chunks <= SMS


def test_plan_small_k():
    assert kmeans_ops.plan(1000, 17, SMS) == (1, 128)
    assert kmeans_ops.plan(64, 512, SMS) == (4, 128)


@pytest.mark.parametrize(
    "shape,way,tile",
    [((256, 1, 305, 768), "row", None), ((1, 16384, 4096, 768), "tile", 128),
     ((256, 305, 305, 768), "tile", 64), ((1, 100, 60, 33), "tile", 64),
     ((1, 15, 4096, 768), "row", None), ((1, 16, 4096, 768), "tile", 64)],
)
def test_pairwise_route_and_tile(shape, way, tile):
    """Serving's query kNN takes the row route; the candidate pass and the
    in-cell batch the tile route, with the tile that pads less."""
    b, n, m, d = shape
    assert pairwise_ops.route(b, n, m, d) == way
    if tile is not None:
        assert pairwise_ops.tile_for(n, m) == tile
