"""The port's PQ and OPQ indexes and the stage-2 table kernel against the
JAX reference, on the CPU.

  * ``rerank_gather_dist``: the plain version against the reference's
    oracle and its Pallas kernel (interpret mode): allclose on real
    tables (rtol 1e-5, atol 1e-5: the sum over D runs in another order)
    and bit-identical on integer-valued tables and queries, where every
    partial sum is exact; ``decode_with_table`` is bit-identical always
    (the same left-to-right chain of f32 adds);
  * JAX-trained, JAX-saved ``PQ8x256,Rerank50`` / ``OPQ8x256,Rerank50``
    indexes open in the port: codes and codebooks equal, stage 1
    bit-identical on the same LUTs, search D allclose (rtol 1e-5,
    atol 1e-5) and ids equal away from near-ties;
  * a port-saved index opens in the reference and searches bit for bit
    as the index it came from;
  * training in each package on the same synthetic set: R@10 within
    0.05 of each other (the k-means draws differ, so never bitwise);
  * the factory grammar, and filtered searches that underfill the pool.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import Index as JIndex
from repro.index import index_factory as jindex_factory
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.data import descriptors
from repro_torch.index import (DedupRerank, Index, OPQIndex, PQIndex,
                               TableRerank, UNQIndex, VmapRerank,
                               candidate_generator_for, index_factory,
                               reranker_for)
from repro_torch.kernels import ops, ref, rerank_dist
from test_torch_index import _assert_search_close

TOL = {"rtol": 1e-5, "atol": 1e-5}
K_FINAL = 10
#: short trainings: the reference's k-means re-traces its step for every
#: call, so its OPQ costs seconds per outer iteration on the CPU
SPECS = {"PQ8x256,Rerank50": {"iters": 25},
         "OPQ8x256,Rerank50": {"outer_iters": 1, "kmeans_iters": 4}}


@pytest.fixture(scope="module")
def jax_indexes(tmp_path_factory):
    """The synthetic set, and each spec trained, filled and saved once by
    the reference."""
    ds = descriptors.make_synthetic_dataset(
        "deep", n_train=6000, n_base=5000, n_query=1000, n_centers=64,
        seed=1, compute_gt=True, device="cpu")
    out = {}
    for spec, kw in SPECS.items():
        j = jindex_factory(spec, dim=96, backend="xla")
        j.train(ds.train, seed=0, **kw)
        j.add(ds.base)
        path = tmp_path_factory.mktemp("jax") / spec.replace(",", "_")
        j.save(path)
        out[spec] = (j, path)
    return ds, out


def _recall_at(ids, gt, k):
    return float((np.asarray(ids)[:, :k] == gt[:, None]).any(axis=1).mean())


# -- the kernel's plain version ------------------------------------------------------

def _rerank_case(seed, q, l, m, k, d, integer):
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, k, (q, l, m)).astype(np.uint8)
    if integer:
        table = rng.integers(-3, 4, (m, k, d)).astype(np.float32)
        queries = rng.integers(-4, 5, (q, d)).astype(np.float32)
    else:
        table = rng.normal(size=(m, k, d)).astype(np.float32)
        queries = rng.normal(size=(q, d)).astype(np.float32)
    return cand, queries, table


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("q,l,m,k,d", [(5, 77, 4, 32, 24),    # ragged L
                                       (3, 130, 8, 256, 96),  # main widths
                                       (7, 9, 16, 64, 32),    # DEEP_16B M
                                       (1, 1, 2, 8, 8)])
def test_rerank_gather_dist_plain_matches_reference(q, l, m, k, d, integer):
    cand, queries, table = _rerank_case(q * l + d, q, l, m, k, d, integer)
    got = ops.rerank_gather_dist(torch.as_tensor(cand),
                                 torch.as_tensor(queries),
                                 torch.as_tensor(table)).numpy()
    oracle = ref.rerank_gather_dist_ref(
        torch.as_tensor(cand), torch.as_tensor(queries),
        torch.as_tensor(table)).numpy()
    for want in (np.asarray(jref.rerank_gather_dist_ref(cand, queries,
                                                        table)),
                 np.asarray(jops.rerank_gather_dist(
                     cand, queries, table, impl="pallas", block_l=16))):
        assert got.shape == want.shape == (q, l)
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, oracle)    # chunks split no sum


def test_rerank_gather_dist_plain_chunks_and_empty_pools():
    cand, queries, table = _rerank_case(0, 4, 50, 4, 16, 12, False)
    args = [torch.as_tensor(a) for a in (cand, queries, table)]
    whole = rerank_dist.rerank_gather_dist_chunked(*args, chunk_l=64)
    for chunk in (1, 7, 50):
        assert torch.equal(rerank_dist.rerank_gather_dist_chunked(
            *args, chunk_l=chunk), whole)
    assert ops.rerank_gather_dist(args[0][:, :0], args[1],
                                  args[2]).shape == (4, 0)


def test_decode_with_table_is_bit_identical():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(8, 64, 40)).astype(np.float32)
    codes = rng.integers(0, 64, (6, 11, 8)).astype(np.uint8)
    got = ref.decode_with_table(torch.as_tensor(codes),
                                torch.as_tensor(table)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.decode_with_table(codes, table)))


# -- reference-saved indexes in the port ------------------------------------------------

@pytest.mark.parametrize("spec", list(SPECS))
def test_jax_saved_index_opens_in_the_port(jax_indexes, spec):
    ds, built = jax_indexes
    j, path = built[spec]
    index = Index.load(path, device="cpu")
    assert type(index) is (OPQIndex if spec.startswith("OPQ") else PQIndex)
    assert (index.ntotal, index.rerank) == (5000, 50)
    np.testing.assert_array_equal(index.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(index.model.codebooks.numpy(),
                                  np.asarray(j.model.codebooks))
    if spec.startswith("OPQ"):
        np.testing.assert_array_equal(index.model.rotation.numpy(),
                                      np.asarray(j.model.rotation))
    np.testing.assert_allclose(index._decode_table().numpy(),
                               np.asarray(j._decode_table()), **TOL)
    assert isinstance(reranker_for(index), TableRerank)

    # stage 1: bit-identical on the same LUTs
    luts = np.array(j._build_luts(jnp.asarray(ds.queries[:40])))
    np.testing.assert_allclose(index._build_luts(torch.as_tensor(
        ds.queries[:40])).numpy(), luts, **TOL)
    want = jref.adc_scan_topl_ref(j.codes, jnp.asarray(luts), None, 50)
    got = candidate_generator_for("cpu").topl(
        index.codes, torch.as_tensor(luts), None, topl=50)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    # end to end, with and without the rerank
    _assert_search_close(index.search(ds.queries, K_FINAL),
                         j.search(ds.queries, K_FINAL))
    _assert_search_close(index.search(ds.queries, K_FINAL, use_rerank=False),
                         j.search(ds.queries, K_FINAL, use_rerank=False))


@pytest.mark.parametrize("spec", list(SPECS))
def test_port_saved_index_opens_in_jax(jax_indexes, spec, tmp_path):
    ds, built = jax_indexes
    j, path = built[spec]
    index = Index.load(path, device="cpu")
    index.save(tmp_path / "port")
    back = JIndex.load(tmp_path / "port")
    assert type(back).__name__ == type(index).__name__
    for got, want in zip(back.search(ds.queries, K_FINAL),
                         j.search(ds.queries, K_FINAL)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    again = Index.load(tmp_path / "port", device="cpu")
    for a, b in zip(again.search(ds.queries, K_FINAL),
                    index.search(ds.queries, K_FINAL)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", list(SPECS))
def test_training_reaches_the_reference_recall(jax_indexes, spec):
    ds, built = jax_indexes
    j = built[spec][0]
    index = index_factory(spec, dim=96, device="cpu")
    assert not index.is_trained
    index.train(ds.train, seed=0, **SPECS[spec]).add(ds.base)
    want = _recall_at(j.search(ds.queries, K_FINAL)[1], ds.gt_nn, 10)
    got = _recall_at(index.search(ds.queries, K_FINAL)[1], ds.gt_nn, 10)
    assert want > 0.5
    assert abs(got - want) <= 0.05, (got, want)


@pytest.mark.parametrize("mask_kind", ["shared", "per_query"])
def test_filtered_search_underfills_the_pool(jax_indexes, mask_kind):
    """Fewer kept points than k: the pool's filtered slots are clamped to
    row 0 before the code gather and come back as (+inf, -1)."""
    ds, built = jax_indexes
    j, path = built["OPQ8x256,Rerank50"]
    index = Index.load(path, device="cpu")
    rng = np.random.default_rng(5)
    q = 24
    mask = rng.random(5000) < 0.0015 if mask_kind == "shared" else \
        rng.random((q, 5000)) < 0.0015
    got = index.search(ds.queries[:q], K_FINAL, filter_mask=mask)
    want = j.search(ds.queries[:q], K_FINAL, filter_mask=mask)
    kept = mask.sum() if mask.ndim == 1 else mask.sum(axis=1)[:, None]
    n_fin = np.isfinite(got[0].numpy()).sum(axis=1)
    np.testing.assert_array_equal(n_fin, np.minimum(kept, K_FINAL).ravel()
                                  if mask.ndim == 2 else
                                  np.full(q, min(kept, K_FINAL)))
    assert (got[1].numpy()[~np.isfinite(got[0].numpy())] == -1).all()
    assert (n_fin < K_FINAL).any()
    _assert_search_close(got, want)


def test_table_rerank_matches_the_materialized_oracle(jax_indexes):
    ds, built = jax_indexes
    index = Index.load(built["OPQ8x256,Rerank50"][1], device="cpu")
    queries = torch.as_tensor(ds.queries[:16])
    cand = torch.as_tensor(np.random.default_rng(0).integers(
        0, 5000, (16, 70)).astype(np.int32))
    got = TableRerank(index._decode_table()).distances(index, queries, cand)
    want = VmapRerank().distances(index, queries, cand)
    torch.testing.assert_close(got, want, **TOL)


# -- factory ------------------------------------------------------------------------

def test_factory_parses_pq_and_opq():
    pq = index_factory("PQ8", dim=96, device="cpu")
    assert type(pq) is PQIndex and (pq.num_books, pq.book_size) == (8, 256)
    assert pq.rerank == 0 and not pq.is_trained
    opq = index_factory("OPQ8x256,Rerank500", dim=96, device="cpu")
    assert type(opq) is OPQIndex and opq.rerank == 500
    assert index_factory("PQ4x16,Rerank7", dim=32, device="cpu").rerank == 7
    assert isinstance(reranker_for(index_factory(
        "UNQ8x256", dim=96, device="cpu")), DedupRerank)
    with pytest.raises(NotImplementedError, match="A5b"):
        index_factory("RVQ8", dim=96, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        index_factory("PQ8", dim=100, device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        UNQIndex(96, device="cpu").train(np.zeros((10, 96), np.float32))
