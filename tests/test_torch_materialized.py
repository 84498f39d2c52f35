"""The port's materialized stage 1 against the JAX reference, on the CPU:
``ops.adc_scan`` / ``ops.adc_scan_batch`` (whose CUDA kernels replace
``adc_scan_pallas`` / ``adc_scan_batch_pallas``), ``MaterializedTopL``
behind the ``onehot`` backend and ``Scan(onehot)``, and
``core.baselines.search_pq``.

Tolerances:
  * bitwise: the scans against the reference's Pallas kernels
    (interpret mode) and oracles; ``MaterializedTopL`` against
    ``StreamingTopL`` and the reference's materialized generator, ties
    and filtered (+inf) entries included; ``Scan(onehot)`` searches
    against the default backend's;
  * ``search_pq``: ids equal to ``repro.core.baselines.search_pq``
    wherever a query's k-th and (k+1)-th exact ADC scores are apart by
    more than 1e-5 (the port builds its LUTs in another summation
    order), and everywhere on integer-valued codebooks and queries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.index import Index as JIndex
from repro.index import index_factory as jindex_factory
from repro.index.candidates import MaterializedTopL as JMaterializedTopL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import baselines as bl
from repro_torch.data import descriptors
from repro_torch.index import (Index, MaterializedTopL, StreamingTopL,
                               backend_supports, candidate_generator_for,
                               index_factory)
from repro_torch.index import candidates
from repro_torch.kernels import ops

SEARCH_GAP = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _scan_case(seed, n, m, k, q, tie_heavy):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    if tie_heavy:
        luts = rng.integers(-2, 3, (q, m, k)).astype(np.float32)
    else:
        luts = rng.normal(size=(q, m, k)).astype(np.float32)
    return rng, codes, luts


# -- the scans ----------------------------------------------------------------------

@pytest.mark.parametrize("n,m,k,q", [(1000, 8, 256, 3), (333, 16, 64, 9),
                                     (77, 3, 20, 1)])
def test_adc_scan_bitwise_vs_jax_pallas(n, m, k, q):
    _, codes, luts = _scan_case(n, n, m, k, q, tie_heavy=False)
    want = jops.adc_scan(jnp.asarray(codes), jnp.asarray(luts[0]),
                         impl="pallas", block_n=128)
    got = ops.adc_scan(_t(codes), _t(luts[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.adc_scan_ref(jnp.asarray(codes),
                                                  jnp.asarray(luts[0]))))


@pytest.mark.parametrize("n,m,k,q", [(1000, 8, 256, 3), (333, 16, 64, 9),
                                     (77, 3, 20, 1)])
def test_adc_scan_batch_bitwise_vs_jax_pallas(n, m, k, q):
    _, codes, luts = _scan_case(n + 1, n, m, k, q, tie_heavy=False)
    want = jops.adc_scan_batch(jnp.asarray(codes), jnp.asarray(luts),
                               impl="pallas", block_n=128, block_q=8)
    got = ops.adc_scan_batch(_t(codes), _t(luts))
    assert got.shape == (q, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(q):                   # each row is that query's adc_scan
        assert torch.equal(got[i], ops.adc_scan(_t(codes), _t(luts[i])))


# -- MaterializedTopL -------------------------------------------------------------------

def _built(path, ds, spec):
    """An index built from the factory string ``spec`` around the saved
    index's trained model, with the same base added (the port's encode
    gives the saved codes back)."""
    index = index_factory(spec, dim=96, device="cpu")
    index.model = Index.load(path, device="cpu").model
    index.add(ds.base)
    return index


@pytest.mark.parametrize("mask", [None, "shared", "per_query"])
@pytest.mark.parametrize("tie_heavy", [True, False])
def test_materialized_equals_streaming_bitwise(mask, tie_heavy):
    n, q, L = 900, 70, 40            # Q above one sort chunk of queries
    rng, codes, luts = _scan_case(11, n, 8, 32, q, tie_heavy)
    bias = rng.integers(-1, 2, (n,)).astype(np.float32)
    qbias = None
    if mask == "shared":
        bias = np.where(rng.random(n) < 0.5, bias, np.inf).astype(np.float32)
    elif mask == "per_query":          # fewer kept points than L
        qbias = np.where(rng.random((q, n)) < 0.02, 0.0, np.inf) \
            .astype(np.float32)
    args = (_t(codes), _t(luts), _t(bias))
    kw = {"topl": L, "qbias": None if qbias is None else _t(qbias)}
    assert candidates.MATERIALIZED_SORT_QUERIES < q
    got = MaterializedTopL().topl(*args, **kw)
    want = StreamingTopL().topl(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    jwant = JMaterializedTopL("xla").topl(
        jnp.asarray(codes), jnp.asarray(luts), jnp.asarray(bias), topl=L,
        qbias=None if qbias is None else jnp.asarray(qbias))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jwant[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jwant[1]))
    if mask == "per_query":
        assert torch.isinf(got[0]).any()


def test_materialized_topl_clamps_and_has_no_quantized_path():
    _, codes, luts = _scan_case(12, 30, 4, 16, 2, tie_heavy=True)
    s, i = MaterializedTopL().topl(_t(codes), _t(luts), None, topl=100)
    assert s.shape == (2, 30) and i.shape == (2, 30)
    gen = MaterializedTopL()
    for kw in ({"lut_dtype": "float16"}, {"overfetch": 2}):
        with pytest.raises(ValueError, match="quantized_lut"):
            gen.topl(_t(codes), _t(luts), None, topl=5, **kw)


def test_candidate_generator_resolves_by_backend_and_device():
    assert isinstance(candidate_generator_for("cpu"), StreamingTopL)
    assert isinstance(candidate_generator_for("cpu", "auto"), StreamingTopL)
    assert isinstance(candidate_generator_for("cpu", "torch"), StreamingTopL)
    assert isinstance(candidate_generator_for("cpu", "onehot"),
                      MaterializedTopL)
    assert not backend_supports("onehot", "streaming_topl")
    assert not backend_supports("onehot", "quantized_lut")
    with pytest.raises(ValueError, match="runs on cuda"):
        candidate_generator_for("cpu", "cuda")


# -- Scan(onehot) through the index ------------------------------------------------------

@pytest.fixture(scope="module")
def opq_case(tmp_path_factory):
    """A JAX-trained, JAX-saved OPQ index over a small synthetic set."""
    ds = descriptors.make_synthetic_dataset(
        "deep", n_train=3000, n_base=3000, n_query=40, n_centers=32,
        seed=4, compute_gt=False)
    j = jindex_factory("OPQ8x256,Rerank60", dim=96, backend="xla")
    j.train(ds.train, seed=0, outer_iters=1, kmeans_iters=4)
    j.add(ds.base)
    path = tmp_path_factory.mktemp("jax") / "opq"
    j.save(path)
    return ds, j, path


def test_factory_scan_components():
    assert index_factory("PQ8,Scan(onehot)", dim=96,
                         device="cpu").backend == "onehot"
    assert index_factory("PQ8,Scan(auto)", dim=96,
                         device="cpu").backend == "torch"
    assert index_factory("UNQ8x256,Rerank500,Scan(onehot)", dim=96,
                         device="cpu").backend == "onehot"
    assert index_factory("OPQ8x256,Rerank60,Scan(auto)", dim=96,
                         device="cpu").backend == "torch"
    for name in ("xla", "pallas", "cuda", "torch"):
        with pytest.raises(NotImplementedError, match="A10"):
            index_factory(f"PQ8,Scan({name})", dim=96, device="cpu")


def _built(path, ds, spec):
    """An index built from the factory string ``spec`` around the saved
    index's trained model, with the same base added (the port's encode
    gives the saved codes back)."""
    index = index_factory(spec, dim=96, device="cpu")
    index.model = Index.load(path, device="cpu").model
    index.add(ds.base)
    return index


@pytest.mark.parametrize("mask", [None, "shared", "per_query"])
@pytest.mark.parametrize("use_rerank", [True, False])
def test_scan_onehot_search_equals_the_default_search(opq_case, mask,
                                                      use_rerank):
    ds, _, path = opq_case
    default = Index.load(path, device="cpu")
    onehot = _built(path, ds, "OPQ8x256,Rerank60,Scan(onehot)")
    assert onehot.backend == "onehot"
    assert torch.equal(onehot.codes, default.codes)
    rng = np.random.default_rng(5)
    filt = {None: None, "shared": rng.random(3000) < 0.5,
            "per_query": rng.random((40, 3000)) < 0.01}[mask]
    want = default.search(ds.queries, 10, use_rerank=use_rerank,
                          filter_mask=filt)
    got = onehot.search(ds.queries, 10, use_rerank=use_rerank,
                        filter_mask=filt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scan_onehot_survives_save_and_load_in_both_packages(opq_case,
                                                             tmp_path):
    ds, j, path = opq_case
    index = _built(path, ds, "OPQ8x256,Rerank60,Scan(onehot)")
    index.save(tmp_path / "port")
    again = Index.load(tmp_path / "port", device="cpu")
    assert again.backend == "onehot"
    assert JIndex.load(tmp_path / "port").backend == "onehot"
    want = index.search(ds.queries, 10)
    got = again.search(ds.queries, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the reference's xla search over the same codes: the same ids away
    # from near-ties
    jd, ji = j.search(jnp.asarray(ds.queries), 10)
    jd, ji = np.asarray(jd), np.asarray(ji)
    gap = np.abs(np.diff(jd, axis=1)) > 1e-4
    apart = np.ones(jd.shape, bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(got[1].numpy()[apart], ji[apart])


# -- search_pq --------------------------------------------------------------------------

@pytest.mark.parametrize("integer", [False, True])
def test_search_pq_ids_match_the_reference(opq_case, integer):
    ds, j, _ = opq_case
    books = np.asarray(j.model.codebooks)
    queries = np.asarray(ds.queries)
    if integer:
        rng = np.random.default_rng(9)
        books = rng.integers(-3, 4, books.shape).astype(np.float32)
        queries = rng.integers(-3, 4, queries.shape).astype(np.float32)
    jmodel = jbl.PQModel(jnp.asarray(books))
    codes = np.asarray(j.codes)
    topk = 20
    want = np.asarray(jbl.search_pq(jmodel, jnp.asarray(queries),
                                    jnp.asarray(codes), topk,
                                    scan_impl="pallas"))
    got = bl.search_pq(bl.PQModel(_t(books)), _t(queries), _t(codes), topk)
    assert got.shape == (len(queries), topk) and got.dtype == torch.int32
    if integer:                            # every LUT entry is exact
        np.testing.assert_array_equal(got.numpy(), want)
        return
    scores = np.stack([np.asarray(jref.adc_scan_ref(
        jnp.asarray(codes), jmodel.lut(jnp.asarray(q)))) for q in queries])
    srt = np.sort(scores, axis=1)
    decided = (srt[:, topk] - srt[:, topk - 1]) > SEARCH_GAP
    assert decided.mean() > 0.9
    for q in np.flatnonzero(decided):
        np.testing.assert_array_equal(np.sort(got.numpy()[q]),
                                      np.sort(want[q]))
        ranks_apart = np.abs(np.diff(scores[q, want[q]])) > SEARCH_GAP
        same = np.concatenate([[True], ranks_apart]) & \
            np.concatenate([ranks_apart, [True]])
        np.testing.assert_array_equal(got.numpy()[q][same], want[q][same])
