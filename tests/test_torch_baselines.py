"""The port's PQ/OPQ training substrate against the JAX reference
(``repro.core.baselines``), on the CPU.

JAX draws its k-means initial centroids and re-seeds from ``jax.random``,
which the port cannot reproduce, so the Lloyd loop is compared from the
same initial centroids (``kmeans(key, x, k, iters=0)`` returns JAX's):

  * Lloyd iterations on data that leaves no cluster empty: assignments
    equal, centroids allclose (rtol 1e-5, atol 1e-6: the cluster sums
    are f32 sums over at most a few hundred rows);
  * an empty cluster is re-seeded from a data point;
  * ``PQModel``: codes equal wherever the two nearest codewords of a
    subspace are apart by more than 1e-5 of the subspace's squared
    distance scale (the distances are f32 sums over D/M terms); LUTs
    and decodes allclose (rtol 1e-5, atol 1e-5);
  * one OPQ Procrustes step from the same data and reconstructions:
    ``u @ vh`` allclose (atol 1e-5), which does not depend on the signs
    the two SVDs pick.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro_torch.core import baselines as bl

GAP_RTOL = 1e-5
TOL = {"rtol": 1e-5, "atol": 1e-5}


def _blobs(seed, n, d, centers):
    """Well separated Gaussian blobs: every Lloyd step assigns each row
    far from any tie, and no cluster goes empty."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 4.0, (centers, d))
    x = c[rng.integers(0, centers, n)] + rng.normal(0, 0.3, (n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("n,d,k,iters", [(2000, 12, 16, 10),
                                         (600, 4, 8, 25),
                                         (300, 24, 6, 5)])
def test_lloyd_matches_jax_from_the_same_init(n, d, k, iters):
    x = _blobs(n + k, n, d, k)
    key = jax.random.PRNGKey(n)
    init = np.array(jbl.kmeans(key, jnp.asarray(x), k, iters=0))
    want = np.asarray(jbl.kmeans(key, jnp.asarray(x), k, iters=iters))
    got = bl.lloyd(torch.as_tensor(x), torch.as_tensor(init), iters,
                   torch.Generator().manual_seed(0))
    want_assign = np.asarray(jbl._assign(jnp.asarray(x), jnp.asarray(want)))
    got_assign = bl._assign(torch.as_tensor(x), got).numpy()
    np.testing.assert_array_equal(got_assign, want_assign)
    assert len(np.unique(got_assign)) == k        # no cluster went empty
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_lloyd_reseeds_an_empty_cluster_from_a_data_point():
    x = torch.as_tensor(_blobs(1, 200, 6, 3))
    far = torch.full((1, 6), 1e3)
    cent = torch.cat([x[:3], far])                  # cluster 3 gets no row
    out = bl.lloyd(x, cent, 1, torch.Generator().manual_seed(0))
    assert (out[3] == x).all(dim=1).any()           # a row of x, exactly
    assign = bl._assign(x, cent)
    for c in range(3):
        torch.testing.assert_close(out[c], x[assign == c].mean(dim=0))


def test_kmeans_init_draws_distinct_rows_when_it_can():
    x = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    gen = torch.Generator().manual_seed(3)
    cent = bl.kmeans_init(x, 20, gen)
    assert len({tuple(r) for r in cent.tolist()}) == 20
    assert bl.kmeans_init(x[:5], 8, gen).shape == (8, 2)   # n < k: replace


def _pq_models(rotated):
    rng = np.random.default_rng(7)
    m, k, d = 4, 32, 24
    books = rng.normal(size=(m, k, d // m)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32) \
        if rotated else None
    jm = jbl.PQModel(jnp.asarray(books),
                     None if rot is None else jnp.asarray(rot))
    tm = bl.PQModel(torch.as_tensor(books),
                    None if rot is None else torch.as_tensor(rot))
    x = rng.normal(size=(500, d)).astype(np.float32)
    return jm, tm, x, books, rot


@pytest.mark.parametrize("rotated", [False, True])
def test_pq_model_encode_lut_decode_match_jax(rotated):
    jm, tm, x, books, rot = _pq_models(rotated)
    got = tm.encode(torch.as_tensor(x)).numpy()
    want = np.asarray(jm.encode(jnp.asarray(x)))
    assert got.dtype == np.uint8
    xr = (x.astype(np.float64) @ rot) if rotated else x.astype(np.float64)
    m, k, d_sub = books.shape
    dist = ((xr.reshape(-1, m, 1, d_sub) - books[None]) ** 2).sum(-1)
    two = np.sort(dist, axis=-1)[..., :2]
    decided = (two[..., 1] - two[..., 0]) > GAP_RTOL * dist.max(axis=-1)
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(got[decided], want[decided])

    luts = tm.lut(torch.as_tensor(x[:9])).numpy()
    want_luts = np.stack([np.asarray(jm.lut(jnp.asarray(q))) for q in x[:9]])
    np.testing.assert_allclose(luts, want_luts, **TOL)
    codes = np.array(want[:50])
    np.testing.assert_allclose(
        tm.decode(torch.as_tensor(codes)).numpy(),
        np.asarray(jm.decode(jnp.asarray(codes))), **TOL)


def test_procrustes_step_matches_jax():
    rng = np.random.default_rng(11)
    train = rng.normal(size=(400, 16)).astype(np.float32)
    recon = (train @ np.linalg.qr(rng.normal(size=(16, 16)))[0]
             + 0.1 * rng.normal(size=(400, 16))).astype(np.float32)
    u, _, vt = jnp.linalg.svd(jnp.asarray(train).T @ jnp.asarray(recon),
                              full_matrices=False)
    want = np.asarray(u @ vt)
    got = bl.procrustes(torch.as_tensor(train), torch.as_tensor(recon))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy().T @ got.numpy(), np.eye(16),
                               atol=1e-5)


def test_train_pq_and_opq_shapes_and_determinism():
    x = torch.as_tensor(_blobs(5, 600, 8, 10))
    pq = bl.train_pq(x, 2, 16, iters=3, generator=torch.Generator()
                     .manual_seed(1))
    assert pq.codebooks.shape == (2, 16, 4) and pq.rotation is None
    opq = [bl.train_opq(x, 2, 16, outer_iters=2, kmeans_iters=2,
                        generator=torch.Generator().manual_seed(1))
           for _ in range(2)]
    assert opq[0].rotation.shape == (8, 8)
    assert torch.equal(opq[0].codebooks, opq[1].codebooks)
    assert torch.equal(opq[0].rotation, opq[1].rotation)
    with pytest.raises(ValueError, match="multiple"):
        bl.train_pq(x, 3, 16, generator=torch.Generator())
