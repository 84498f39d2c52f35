"""The port's reduced-precision stage 1 against the JAX reference, on the
CPU: ``lut_quant``, the quantized pool scan, the exact re-score and
``Index.search(lut_dtype=..., overfetch=...)``.

Tolerances:
  * bitwise: ``quantize_luts`` (f16 tables, i8 codes and scales, edge
    rows included), quantized pools (scores and ids) against
    ``repro.kernels.ref.adc_scan_topl_q_ref`` and the reference's Pallas
    kernel (interpret mode), and the final (scores, ids) of
    ``ops.adc_scan_topl`` against the reference's ``ops.adc_scan_topl``;
  * index searches on JAX-saved UNQ and OPQ indexes: ids equal to the
    reference's quantized search away from near-ties (D allclose, rtol
    1e-5, atol 1e-5, as ``tests/test_torch_index.py`` states), and
    recall@k >= 0.999 against the exact search (the reference's own
    floor, ``tests/test_quantized.py``);
  * the kernel's queries-per-block choice, checked as a pure function.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unq as junq
from repro.index import Index as JIndex
from repro.index import index_factory as jindex_factory
from repro.index.unq_index import UNQIndex as JUNQIndex
from repro.kernels import lut_quant as jlut_quant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.unq_paper import SMOKE
from repro_torch.core import unq
from repro_torch.data import descriptors
from repro_torch.index import Index, index_factory
from repro_torch.kernels import build, lut_quant, ops, ref, topl_scan
from test_torch_index import _assert_search_close, _jax_tree

def _t(x):
    return torch.as_tensor(np.array(x))


def _recall(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.mean([len(set(got[q]) & set(want[q])) / want.shape[1]
                    for q in range(want.shape[0])])


def _scan_case(seed, n, m, k, q, tie_heavy):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    if tie_heavy:
        luts = rng.integers(-2, 3, (q, m, k)).astype(np.float32)
    else:
        luts = rng.normal(size=(q, m, k)).astype(np.float32)
    return rng, codes, luts


def _edge_luts(k=32):
    """One row per (k, case): a span hi - lo of exactly 254 * 2^k (so the
    raw span is a power of two), one ulp above it and one ulp below."""
    rng = np.random.default_rng(7)
    rows = []
    for e in range(-40, 24):
        span0 = np.float32(254.0) * np.float32(2.0 ** e)
        for span in (span0, np.nextafter(span0, np.float32(np.inf)),
                     np.nextafter(span0, np.float32(0))):
            row = (rng.uniform(0, 1, k) * span).astype(np.float32) - span / 3
            row[0], row[1] = -span / 3, span - span / 3
            rows.append(row)
    return np.stack(rows)[:, None, :].astype(np.float32)


def _quant_cases():
    rng = np.random.default_rng(0)
    wide = rng.normal(size=(48, 8, 32)) * \
        np.exp(rng.uniform(-35, 35, (48, 8, 1)))
    return {
        "normal": rng.normal(size=(16, 8, 64)).astype(np.float32),
        "wide_range": wide.astype(np.float32),
        "edge_rows": _edge_luts(),
        "integer": rng.integers(-300, 300, (16, 8, 64)).astype(np.float32),
        "constant_rows": np.ones((3, 4, 16), np.float32),
    }


# -- lut_quant ------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(_quant_cases()))
@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_quantize_luts_bitwise_vs_jax(case, lut_dtype):
    luts = _quant_cases()[case]
    jq, js = jlut_quant.quantize_luts(jnp.asarray(luts), lut_dtype)
    tq, ts = lut_quant.quantize_luts(_t(luts), lut_dtype)
    assert tq.dtype == {"float16": torch.float16,
                        "int8": torch.int8}[lut_dtype]
    np.testing.assert_array_equal(tq.numpy().view(np.uint8),
                                  np.asarray(jq).view(np.uint8))
    if lut_dtype == "float16":
        assert js is None and ts is None
    else:
        assert ts.dtype == torch.float32 and ts.shape == luts.shape[:2]
        np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))


def test_int8_scale_follows_the_reference_not_the_ideal_power_of_two():
    """At the edges the reference's scale is not the smallest power of
    two >= raw (XLA's f32 log and exp): the port follows the reference.
    Pinned here so that a change on either side shows."""
    luts = _edge_luts()
    _, ts = lut_quant.quantize_luts(_t(luts), "int8")
    raw = (luts.max(-1) - luts.min(-1)) * np.float32(1 / 254)
    m, e = np.frexp(raw.astype(np.float32))
    ideal = np.ldexp(np.float32(1), np.where(m == 0.5, e - 1, e))
    off = ts.numpy() != ideal
    assert off.any() and not off.all()
    assert (ts.numpy() > 0).all()
    # where the scale is an exact power of two, it is the ideal one or
    # the next (an exact power of two raw can round up)
    m_s, e_s = np.frexp(ts.numpy())
    pow2 = m_s == 0.5
    assert np.isin(ts.numpy()[pow2] / ideal[pow2], [0.5, 1.0, 2.0]).all()


def test_quantize_luts_passthrough_and_rejection():
    luts = torch.randn(2, 3, 8)
    same, none = lut_quant.quantize_luts(luts, "float32")
    assert torch.equal(same, luts) and none is None
    with pytest.raises(ValueError, match="lut_dtype"):
        lut_quant.check_lut_dtype("bf16")


def test_pool_width_semantics():
    assert lut_quant.pool_width(10, 2, 1000) == 20
    assert lut_quant.pool_width(10, 200, 64) == 64
    assert lut_quant.pool_width(10, 1, 1000) == 10
    assert lut_quant.pool_width(500, 3, 1_000_000) == 1500
    with pytest.raises(ValueError, match="overfetch"):
        lut_quant.pool_width(10, 0, 1000)


def test_exact_topl_tie_contract():
    s = torch.tensor([[2.0, 1.0, 1.0, 3.0, -0.0, 0.0, float("inf")]])
    g = torch.tensor([[7, 9, 4, 1, 8, 3, 0]], dtype=torch.int32)
    ts, tg = lut_quant.exact_topl(s, g, 6)
    assert tg.tolist() == [[3, 8, 4, 9, 7, 1]]
    js, jg = jlut_quant.exact_topl(jnp.asarray(s.numpy()),
                                   jnp.asarray(g.numpy()), 6)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- the quantized pool scan ------------------------------------------------------

@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
@pytest.mark.parametrize("tie_heavy", [True, False])
@pytest.mark.parametrize("filtered", [False, True])
def test_quantized_pool_bitwise_vs_jax(lut_dtype, tie_heavy, filtered):
    """The pool the port selects (plain stream) equals the reference's
    oracle and its Pallas kernel, scores and ids, bit for bit."""
    n, q, L = 700, 5, 33
    rng, codes, luts = _scan_case(3, n, 8, 32, q, tie_heavy)
    bias = rng.integers(0, 3, (n,)).astype(np.float32)
    qbias = np.where(rng.random((q, n)) < 0.97, 0.0, np.inf) \
        .astype(np.float32) if filtered else None
    jq, js = jlut_quant.quantize_luts(jnp.asarray(luts), lut_dtype)
    jqb = None if qbias is None else jnp.asarray(qbias)
    want = jref.adc_scan_topl_q_ref(jnp.asarray(codes), jq, js,
                                    jnp.asarray(bias), L, jqb)
    pallas = jops._scan_topl_run(jnp.asarray(codes), jq, js,
                                 jnp.asarray(bias), jqb, topl=L,
                                 impl="pallas", block_n=128, block_q=8,
                                 chunk_n=None)
    tq, ts = lut_quant.quantize_luts(_t(luts), lut_dtype)
    got = ops._scan_topl_run(_t(codes), tq, ts, _t(bias),
                             None if qbias is None else _t(qbias), topl=L)
    oracle = ref.adc_scan_topl_q_ref(_t(codes), tq, ts, _t(bias), L,
                                     None if qbias is None else _t(qbias))
    for w, p, g, o in zip(want, pallas, got, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), o.numpy())


@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_adc_scan_batch_q_ref_bitwise_vs_jax(lut_dtype):
    _, codes, luts = _scan_case(4, 333, 8, 256, 4, tie_heavy=False)
    luts = luts * np.float32(1e4)             # scales away from 2^0
    jq, js = jlut_quant.quantize_luts(jnp.asarray(luts), lut_dtype)
    tq, ts = lut_quant.quantize_luts(_t(luts), lut_dtype)
    np.testing.assert_array_equal(
        ref.adc_scan_batch_q_ref(_t(codes), tq, ts).numpy(),
        np.asarray(jref.adc_scan_batch_q_ref(jnp.asarray(codes), jq, js)))


# -- the final (re-scored) results ---------------------------------------------------

@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
@pytest.mark.parametrize("overfetch", [2, 3])
@pytest.mark.parametrize("tie_heavy", [True, False])
def test_quantized_search_bitwise_vs_jax(lut_dtype, overfetch, tie_heavy):
    """ops.adc_scan_topl with lut_dtype/overfetch against the reference's
    xla path, with bias and qbias streams. The filter keeps every pool
    full: the reference's xla stream gives filtered pool entries the pad
    id (ROADMAP C, closed entry), which the Pallas case below covers."""
    n, q, L = 900, 6, 40
    rng, codes, luts = _scan_case(5, n, 8, 32, q, tie_heavy)
    bias = rng.integers(-1, 2, (n,)).astype(np.float32)
    qbias = np.where(rng.random((q, n)) < 0.9, 0.0, np.inf).astype(np.float32)
    want = jops.adc_scan_topl(jnp.asarray(codes), jnp.asarray(luts), topl=L,
                              bias=jnp.asarray(bias), qbias=jnp.asarray(qbias),
                              impl="xla", lut_dtype=lut_dtype,
                              overfetch=overfetch)
    got = ops.adc_scan_topl(_t(codes), _t(luts), topl=L, bias=_t(bias),
                            qbias=_t(qbias), lut_dtype=lut_dtype,
                            overfetch=overfetch)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_quantized_search_underfilled_pool_vs_jax_pallas(lut_dtype):
    """A filter that keeps fewer points than the pool: +inf entries keep
    their real ids in ascending order, as the reference's Pallas path
    gives them."""
    n, q, L = 400, 3, 20
    rng, codes, luts = _scan_case(6, n, 4, 16, q, tie_heavy=True)
    qbias = np.where(rng.random((q, n)) < 0.05, 0.0, np.inf) \
        .astype(np.float32)
    want = jops.adc_scan_topl(jnp.asarray(codes), jnp.asarray(luts), topl=L,
                              qbias=jnp.asarray(qbias), impl="pallas",
                              lut_dtype=lut_dtype, overfetch=2, block_n=128)
    got = ops.adc_scan_topl(_t(codes), _t(luts), topl=L, qbias=_t(qbias),
                            lut_dtype=lut_dtype, overfetch=2)
    assert np.isinf(np.asarray(want[0])).any()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_full_pool_is_bitwise_the_exact_path(lut_dtype):
    """overfetch = N: the pool is the whole population, so the result is
    the exact path's, scores, ids, ties and +inf filters included."""
    n, q, L = 500, 6, 29
    rng, codes, luts = _scan_case(7, n, 8, 16, q, tie_heavy=True)
    bias = rng.integers(0, 2, (n,)).astype(np.float32)
    qbias = np.where(rng.random((q, n)) < 0.05, np.inf, 0.0) \
        .astype(np.float32)
    args = (_t(codes), _t(luts))
    kw = {"topl": L, "bias": _t(bias), "qbias": _t(qbias)}
    want = ops.adc_scan_topl(*args, **kw)
    got = ops.adc_scan_topl(*args, lut_dtype=lut_dtype, overfetch=n, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    oracle = ref.adc_scan_topl_ref(*args, _t(bias), L, _t(qbias))
    assert torch.equal(got[0], oracle[0]) and torch.equal(got[1], oracle[1])


def test_overfetch_alone_is_a_bitwise_noop():
    _, codes, luts = _scan_case(8, 400, 4, 16, 4, tie_heavy=True)
    want = ops.adc_scan_topl(_t(codes), _t(luts), topl=21)
    got = ops.adc_scan_topl(_t(codes), _t(luts), topl=21, overfetch=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_quantized_recall_floor(seed, lut_dtype):
    """The reference's operating point: recall@L >= 0.999 at overfetch 2."""
    rng = np.random.default_rng(seed)
    _, codes, luts = _scan_case(seed, 2048, 8, 32, 6,
                                tie_heavy=bool(rng.integers(0, 2)))
    _, want = ops.adc_scan_topl(_t(codes), _t(luts), topl=64)
    _, got = ops.adc_scan_topl(_t(codes), _t(luts), topl=64,
                               lut_dtype=lut_dtype, overfetch=2)
    assert _recall(got, want) >= 0.999


# -- the kernel's queries per block (C1), as a pure function -------------------------

@pytest.mark.parametrize("m,k,topl,lut_dtype,bq", [
    (8, 256, 500, "float32", 8),
    (8, 256, 1000, "float16", 8),
    (8, 256, 1000, "int8", 8),
    (8, 256, 1025, "float32", 8),
    (8, 256, 1500, "float32", 8),
    (8, 256, 8192, "float32", 2),
    (8, 256, 4096, "float32", 4),
    (8, 256, 16384, "float32", 1),
    (32, 256, 500, "float32", 4),
    (32, 256, 4096, "float32", 2),
    (16, 256, 1000, "float32", 8),
    (3, 70, 5, "int8", 8)])
def test_block_q_choice(m, k, topl, lut_dtype, bq):
    assert topl_scan.block_q(m, k, topl, lut_dtype) == bq
    assert topl_scan.smem_bytes(bq, m, k, topl, lut_dtype) <= \
        build.MAX_SMEM_BYTES
    if bq < 8:
        assert topl_scan.smem_bytes(2 * bq, m, k, topl, lut_dtype) > \
            build.MAX_SMEM_BYTES


def test_block_q_smem_formula_and_the_shape_that_fits_nowhere():
    # f32 tables, BQ = 8, M = 8, K = 256, L = 500 (LP = 512, CAP = 512):
    # 65,536 B of tables + 8 * 8 * (512 + 512) B of pairs + 32 B of counts
    assert topl_scan.smem_bytes(8, 8, 256, 500) == 65_536 + 65_536 + 32
    # i8 tables also hold their (BQ, M) scales, 16-byte aligned
    assert topl_scan.smem_bytes(1, 3, 70, 5, "int8") == \
        224 + 16 + 8 * (32 + 64) + 4
    assert topl_scan.heap_width(1) == 32 and topl_scan.heap_width(1025) == 2048
    with pytest.raises(ValueError, match=r"270852 B .* 232448 B"):
        topl_scan.block_q(8, 256, 16_385)
    with pytest.raises(ValueError, match="shared memory"):
        topl_scan.block_q(256, 256, 10)


# -- index searches: JAX-saved indexes in the port --------------------------------------

@pytest.fixture(scope="module")
def saved_indexes(tmp_path_factory):
    """A JAX-built UNQ index (numpy weights) and a JAX-trained OPQ index,
    each saved by the reference, and their exact and quantized results
    in the reference."""
    cfg = SMOKE
    ds = descriptors.make_synthetic_dataset(
        "deep", dim=cfg.dim, n_train=3000, n_base=3000, n_query=32,
        n_centers=32, seed=3, compute_gt=False)
    params, state = unq.numpy_params(cfg, 0, bn_stats=True, center=ds.train)
    jcfg = junq.UNQConfig(**dataclasses.asdict(cfg))
    junq_index = JUNQIndex.from_trained(_jax_tree(params), _jax_tree(state),
                                        jcfg, rerank=100, backend="xla")
    junq_index.add(ds.base)
    jopq = jindex_factory("OPQ8x256,Rerank100", dim=cfg.dim, backend="xla")
    jopq.train(ds.train, seed=0, outer_iters=1, kmeans_iters=4)
    jopq.add(ds.base)
    out = {}
    for name, j in (("unq", junq_index), ("opq", jopq)):
        path = tmp_path_factory.mktemp("jax") / name
        j.save(path)
        res = {"exact": j.search(ds.queries, 10, use_rerank=False)}
        for dt in ("float16", "int8"):
            res[dt] = j.search(ds.queries, 10, use_rerank=False,
                               lut_dtype=dt, overfetch=2)
            res[dt + "_rerank"] = j.search(ds.queries, 10, lut_dtype=dt,
                                           overfetch=2)
        out[name] = (path, res)
    return ds, out


@pytest.mark.parametrize("name", ["unq", "opq"])
@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_jax_saved_index_quantized_search_in_the_port(saved_indexes, name,
                                                      lut_dtype):
    ds, out = saved_indexes
    path, res = out[name]
    index = Index.load(path, device="cpu")
    assert index.backend == "torch"
    exact = index.search(ds.queries, 10, use_rerank=False)
    got = index.search(ds.queries, 10, use_rerank=False,
                       lut_dtype=lut_dtype, overfetch=2)
    # stage 1 over the same codes: the port's LUTs come from the same
    # weights within float rounding, so ids agree away from near-ties
    _assert_search_close(got, res[lut_dtype])
    assert _recall(got[1], exact[1]) >= 0.999
    assert _recall(got[1], res["exact"][1]) >= 0.999
    reranked = index.search(ds.queries, 10, lut_dtype=lut_dtype,
                            overfetch=2)
    _assert_search_close(reranked, res[lut_dtype + "_rerank"])


@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
def test_index_quantized_search_on_the_reference_luts_is_bitwise(
        saved_indexes, lut_dtype):
    """Given the reference's own LUTs and codes, the port's quantized
    stage 1 returns the reference's (d2, ids) bit for bit."""
    ds, out = saved_indexes
    path, _ = out["unq"]
    jindex = JIndex.load(path)
    luts = np.asarray(jindex._build_luts(jnp.asarray(ds.queries)))
    want = jops.adc_scan_topl(jindex.codes, jnp.asarray(luts), topl=50,
                              impl="xla", lut_dtype=lut_dtype, overfetch=2)
    got = ops.adc_scan_topl(_t(np.asarray(jindex.codes)), _t(luts), topl=50,
                            lut_dtype=lut_dtype, overfetch=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_quantized_requests_are_gated_on_the_backend(saved_indexes):
    ds = saved_indexes[0]
    index = index_factory("PQ8x256,Scan(onehot)", dim=SMOKE.dim,
                          device="cpu")
    index.train(ds.train[:600], iters=2).add(ds.base[:600])
    assert index.backend == "onehot"
    with pytest.raises(ValueError, match="unknown lut_dtype"):
        index.search(ds.queries, 5, lut_dtype="bf16")
    with pytest.raises(ValueError, match="quantized_lut"):
        index.search(ds.queries, 5, lut_dtype="int8", overfetch=2)
    with pytest.raises(ValueError, match="quantized_lut"):
        index.search(ds.queries, 5, overfetch=2)
