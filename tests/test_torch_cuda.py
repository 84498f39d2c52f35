"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA Hopper card and skips without one;
the module imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

``adc_scan_topl`` must equal the plain stream bit for bit in (score, id),
ties and filtered (+inf) entries included, on f32, f16 and i8 tables and
at every block size (wide heaps, M = 32); ``adc_scan`` and
``adc_scan_batch`` must equal their plain versions bit for bit, and
``quantize_luts`` on the card must give the CPU's scales and codes. ``unq_encode`` sums its dot
products in another order than the plain einsum, so codes must be equal
wherever the top-2 score gap exceeds 1e-5 of the row's largest |score|.
``rerank_gather_dist`` sums over D in another order than the plain
version: d1 allclose (rtol 1e-5, atol 1e-5) on real tables, bit-identical
on integer-valued ones.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs.unq_paper import SMOKE
from repro_torch.core import unq
from repro_torch.data import descriptors
from repro_torch.index import (Index, UNQIndex, candidate_generator_for,
                               index_factory)
from repro_torch.kernels import (adc_scan, lut_quant, ops, ref, rerank_dist,
                                 topl_scan, unq_encode)

ENCODE_GAP_RTOL = 1e-5
TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built for sm_90a)")
    return torch.device("cuda")


def _decided(heads, books):
    """(B, M) True where the top-2 scores are apart by more than
    rounding (float64 scores)."""
    s = torch.einsum("bmd,mkd->bmk", heads.double(), books.double())
    top2 = torch.topk(s, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > \
        ENCODE_GAP_RTOL * s.abs().amax(dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,L,tie_heavy,filtered,slices", [
    (100_003, 8, 500, False, False, None),
    (100_003, 8, 500, True, False, None),
    (100_003, 8, 500, True, False, 1),     # one slice: no cross-slice merge
    (20_011, 8, 100, True, True, 13),
    (20_011, 16, 1000, False, True, None),  # DEEP_16B width, widest heap
    (300, 8, 300, False, True, None),      # L == N
    (5, 8, 1, True, False, None)])
def test_adc_scan_topl_cuda_matches_plain(cuda_device, n, m, L, tie_heavy,
                                          filtered, slices):
    q = 13
    rng = np.random.default_rng(n + L)
    codes = torch.as_tensor(rng.integers(0, 256, (n, m)).astype(np.uint8))
    luts = rng.integers(-2, 3, (q, m, 256)) if tie_heavy else \
        rng.normal(size=(q, m, 256))
    luts = torch.as_tensor(luts.astype(np.float32))
    bias = torch.as_tensor(rng.integers(-1, 2, (n,)).astype(np.float32))
    qbias = torch.as_tensor(np.where(rng.random((q, n)) < 0.9, 0.0, np.inf)
                            .astype(np.float32)) if filtered else None
    want = ops.adc_scan_topl(codes, luts, topl=L, bias=bias, qbias=qbias)
    dev = [t.to(cuda_device) if t is not None else None
           for t in (codes, luts, bias, qbias)]
    padded = torch.cat([dev[1], dev[1].new_zeros((16 - q, m, 256))])
    got = topl_scan.adc_scan_topl_cuda(dev[0], padded, dev[2], dev[3],
                                       topl=L, num_queries=q, slices=slices)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,d", [(8192, 8, 256, 256), (256, 16, 256, 256),
                                     (100, 4, 64, 32), (64, 3, 70, 18)])
def test_unq_encode_cuda_matches_plain(cuda_device, b, m, k, d):
    rng = np.random.default_rng(b)
    heads = torch.as_tensor(rng.normal(size=(b, m, d)).astype(np.float32))
    books = torch.as_tensor(rng.normal(size=(m, k, d)).astype(np.float32))
    want = ops.unq_encode(heads, books)
    got = ops.unq_encode(heads.to(cuda_device), books.to(cuda_device)).cpu()
    torch.cuda.synchronize()
    decided = _decided(heads, books)
    assert decided.float().mean() > 0.99
    assert torch.equal(got[decided], want[decided])


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    heads = torch.zeros((64, 2, 8), device=cuda_device)
    books = torch.zeros((2, 16, 8), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of"):
        unq_encode.unq_encode_cuda(heads[:10], books)
    with pytest.raises(ValueError, match="contiguous"):
        unq_encode.unq_encode_cuda(heads, books.transpose(1, 2)
                                   .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        unq_encode.unq_encode_cuda(heads, books.cpu())
    codes = torch.zeros((100, 2), dtype=torch.uint8, device=cuda_device)
    luts = torch.zeros((8, 2, 16), device=cuda_device)
    bias = torch.zeros((100,), device=cuda_device)
    with pytest.raises(ValueError, match="topl"):
        topl_scan.adc_scan_topl_cuda(codes, luts, bias, topl=101,
                                     num_queries=8)
    with pytest.raises(ValueError, match="float32"):
        topl_scan.adc_scan_topl_cuda(codes, luts.double(), bias, topl=5,
                                     num_queries=8)


@pytest.mark.cuda
def test_main_path_on_the_card_matches_cpu(cuda_device):
    """The flat index on the card (both kernels) against the same index
    on the CPU (the plain versions) at a small size."""
    cfg = SMOKE
    ds = descriptors.make_synthetic_dataset(
        "deep", dim=cfg.dim, n_train=500, n_base=5000, n_query=32,
        n_centers=32, seed=1, compute_gt=False)
    params, state = unq.numpy_params(cfg, 0, bn_stats=True, center=ds.train)
    model = unq.unq_from_jax(params, state, cfg)
    cpu = UNQIndex.from_trained(model, rerank=64, device="cpu").add(ds.base)
    launches = (unq_encode.unq_encode_cuda.launches,
                topl_scan.adc_scan_topl_cuda.launches)
    gpu = UNQIndex.from_trained(copy.deepcopy(model), rerank=64,
                                device=cuda_device).add(ds.base)
    with torch.no_grad():
        heads = model.encode_heads(torch.as_tensor(ds.base))
    decided = _decided(heads, model.codebooks)
    assert torch.equal(gpu.codes.cpu()[decided], cpu.codes[decided])
    gpu = UNQIndex.from_trained(copy.deepcopy(model), codes=cpu.codes,
                                rerank=64, device=cuda_device)
    rng = np.random.default_rng(0)
    for mask in (None, rng.random(5000) < 0.5, rng.random((32, 5000)) < 0.01):
        want = cpu.search(ds.queries, 10, filter_mask=mask)
        got = [x.cpu() for x in gpu.search(ds.queries, 10, filter_mask=mask)]
        assert torch.equal(torch.isinf(got[0]), torch.isinf(want[0]))
        fin = torch.isfinite(want[0])
        np.testing.assert_allclose(got[0][fin].numpy(), want[0][fin].numpy(),
                                   **TOL)
        apart = torch.ones_like(fin)      # ids agree away from near-ties
        gap = (want[0][:, 1:] - want[0][:, :-1]).abs() > 1e-4
        apart[:, 1:] &= gap
        apart[:, :-1] &= gap
        assert torch.equal(got[1][apart & fin], want[1][apart & fin])
        assert torch.equal(got[1][~fin], want[1][~fin])
    assert unq_encode.unq_encode_cuda.launches > launches[0]
    assert topl_scan.adc_scan_topl_cuda.launches > launches[1]


@pytest.mark.cuda
@pytest.mark.parametrize("q,l,m,k,d,integer", [
    (1000, 500, 8, 256, 96, False),     # the main path's shapes
    (1000, 500, 8, 256, 96, True),
    (13, 77, 16, 256, 96, False),       # DEEP_16B widths, ragged L
    (5, 130, 2, 16, 200, False),        # D > 192, no multiple of 32
    (3, 1, 4, 64, 32, True)])
def test_rerank_gather_dist_cuda_matches_plain(cuda_device, q, l, m, k, d,
                                               integer):
    rng = np.random.default_rng(q + l + d)
    cand = torch.as_tensor(rng.integers(0, k, (q, l, m)).astype(np.uint8))
    if integer:
        table = rng.integers(-3, 4, (m, k, d))
        queries = rng.integers(-4, 5, (q, d))
    else:
        table = rng.normal(size=(m, k, d))
        queries = rng.normal(size=(q, d))
    table = torch.as_tensor(table.astype(np.float32))
    queries = torch.as_tensor(queries.astype(np.float32))
    want = ops.rerank_gather_dist(cand, queries, table)
    before = rerank_dist.rerank_gather_dist_cuda.launches
    got = ops.rerank_gather_dist(cand.to(cuda_device),
                                 queries.to(cuda_device),
                                 table.to(cuda_device)).cpu()
    torch.cuda.synchronize()
    assert rerank_dist.rerank_gather_dist_cuda.launches == before + 1
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_rerank_gather_dist_cuda_guards_its_inputs(cuda_device):
    table = torch.zeros((2, 64, 32), device=cuda_device)
    queries = torch.zeros((3, 32), device=cuda_device)
    cand = torch.zeros((3, 5, 2), dtype=torch.uint8, device=cuda_device)
    cand[1, 2, 1] = 200                      # a code past K=64
    out = rerank_dist.rerank_gather_dist_cuda(cand, queries, table)
    torch.cuda.synchronize()
    assert torch.isnan(out[1, 2]) and int(torch.isnan(out).sum()) == 1
    with pytest.raises(ValueError, match="uint8"):
        rerank_dist.rerank_gather_dist_cuda(cand.int(), queries, table)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rerank_dist.rerank_gather_dist_cuda(cand, queries.cpu(), table)
    with pytest.raises(ValueError, match="contiguous"):
        rerank_dist.rerank_gather_dist_cuda(
            cand, queries, table.transpose(1, 2).contiguous()
            .transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["PQ8x256,Rerank100", "OPQ8x256,Rerank100"])
def test_pq_index_on_the_card_matches_cpu(cuda_device, spec, tmp_path):
    """Train, add and search on the card; the same trained index on the
    CPU (the plain versions), including filters that underfill the
    pool (fewer kept points than k)."""
    ds = descriptors.make_synthetic_dataset(
        "deep", n_train=4000, n_base=20_000, n_query=64, n_centers=64,
        seed=2, compute_gt=False)
    gpu = index_factory(spec, dim=96, device=cuda_device)
    gpu.train(ds.train, outer_iters=2, kmeans_iters=5).add(ds.base)
    gpu.save(tmp_path / "index")
    cpu = Index.load(tmp_path / "index", device="cpu")
    launches = rerank_dist.rerank_gather_dist_cuda.launches
    rng = np.random.default_rng(0)
    for mask in (None, rng.random(20_000) < 3e-4,
                 rng.random((64, 20_000)) < 3e-4):
        want = cpu.search(ds.queries, 10, filter_mask=mask)
        got = [x.cpu() for x in gpu.search(ds.queries, 10, filter_mask=mask)]
        assert torch.equal(torch.isinf(got[0]), torch.isinf(want[0]))
        fin = torch.isfinite(want[0])
        if mask is not None:
            assert (~fin).any()
        np.testing.assert_allclose(got[0][fin].numpy(), want[0][fin].numpy(),
                                   **TOL)
        apart = torch.ones_like(fin)
        gap = (want[0][:, 1:] - want[0][:, :-1]).abs() > 1e-4
        apart[:, 1:] &= gap
        apart[:, :-1] &= gap
        assert torch.equal(got[1][apart & fin], want[1][apart & fin])
        assert (got[1][~fin] == -1).all()
    assert rerank_dist.rerank_gather_dist_cuda.launches == launches + 3


def _scan_inputs(rng, n, m, q, tie_heavy, filtered):
    codes = torch.as_tensor(rng.integers(0, 256, (n, m)).astype(np.uint8))
    luts = rng.integers(-2, 3, (q, m, 256)) if tie_heavy else \
        rng.normal(size=(q, m, 256))
    luts = torch.as_tensor(luts.astype(np.float32))
    bias = torch.as_tensor(rng.integers(-1, 2, (n,)).astype(np.float32))
    qbias = torch.as_tensor(np.where(rng.random((q, n)) < 0.9, 0.0, np.inf)
                            .astype(np.float32)) if filtered else None
    return codes, luts, bias, qbias


@pytest.mark.cuda
@pytest.mark.parametrize("lut_dtype", ["float16", "int8"])
@pytest.mark.parametrize("n,m,L,tie_heavy,filtered", [
    (100_003, 8, 1000, False, False),
    (100_003, 8, 1000, True, True),
    (20_011, 16, 300, False, True),
    (300, 8, 300, False, False)])
def test_adc_scan_topl_quantized_cuda_matches_plain(cuda_device, lut_dtype, n,
                                                    m, L, tie_heavy,
                                                    filtered):
    """The f16 and i8 faces against the plain stream on the same
    quantized tables, bit for bit."""
    q = 11
    rng = np.random.default_rng(n + m + L)
    codes, luts, bias, qbias = _scan_inputs(rng, n, m, q, tie_heavy,
                                            filtered)
    qluts, scale = lut_quant.quantize_luts(luts, lut_dtype)
    want = topl_scan.adc_scan_topl_stream(codes, qluts, bias, qbias, scale,
                                          topl=L, n_valid=n)
    oracle = ref.adc_scan_topl_q_ref(codes, qluts, scale, bias, L, qbias)
    assert torch.equal(want[0], oracle[0]) and torch.equal(want[1], oracle[1])
    bq = topl_scan.block_q(m, 256, L, lut_dtype)
    pad = (-q) % bq
    dev = [t.to(cuda_device) if t is not None else None
           for t in (codes, qluts, bias, qbias, scale)]
    padded = torch.cat([dev[1], dev[1].new_zeros((pad, m, 256))])
    sc = None if scale is None else \
        torch.cat([dev[4], dev[4].new_zeros((pad, m))])
    before = topl_scan.adc_scan_topl_cuda.launches
    got = topl_scan.adc_scan_topl_cuda(dev[0], padded, dev[2], dev[3], sc,
                                       topl=L, num_queries=q)
    torch.cuda.synchronize()
    assert topl_scan.adc_scan_topl_cuda.launches == before + 2
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,L,lut_dtype,bq", [
    (200_003, 8, 1025, "float32", 8),
    (200_003, 8, 1500, "float32", 8),
    (200_003, 8, 4096, "float32", 4),
    (100_000, 32, 500, "float32", 4),     # PQ32x256: no block size fitted
    (60_001, 32, 4096, "float32", 2),
    (40_009, 8, 16384, "float32", 1),     # one warp per block
    (100_003, 8, 4096, "int8", 4),
    (100_003, 32, 1500, "float16", 4)])
def test_adc_scan_topl_cuda_wide_heaps_and_books(cuda_device, n, m, L,
                                                 lut_dtype, bq):
    """Shapes the kernel refused before it chose its queries per block:
    bit-identical to the plain stream through ``ops.adc_scan_topl``."""
    assert topl_scan.block_q(m, 256, L, lut_dtype) == bq
    q = 6
    rng = np.random.default_rng(n + L)
    codes, luts, bias, qbias = _scan_inputs(rng, n, m, q, False, True)
    qluts, scale = lut_quant.quantize_luts(luts, lut_dtype)
    want = topl_scan.adc_scan_topl_stream(codes, qluts, bias, qbias, scale,
                                          topl=L, n_valid=n)
    dev = [t.to(cuda_device) if t is not None else None
           for t in (codes, qluts, bias, qbias, scale)]
    got = ops._scan_topl_run(dev[0], dev[1], dev[4], dev[2], dev[3], topl=L)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bq,m,L,lut_dtype", [
    (8, 8, 500, "float32"), (8, 8, 1000, "float16"), (8, 8, 1000, "int8"),
    (4, 32, 500, "float32"), (1, 8, 16384, "float32"), (2, 3, 70, "int8")])
def test_block_q_smem_matches_the_kernel(cuda_device, bq, m, L, lut_dtype):
    assert topl_scan.smem_bytes(bq, m, 256, L, lut_dtype) == \
        topl_scan.kernel_smem_bytes(bq, m, 256, L, lut_dtype)


@pytest.mark.cuda
def test_shape_that_fits_nowhere_raises_before_launch(cuda_device):
    codes = torch.zeros((20_000, 8), dtype=torch.uint8, device=cuda_device)
    luts = torch.zeros((8, 8, 256), device=cuda_device)
    bias = torch.zeros((20_000,), device=cuda_device)
    torch.cuda.synchronize()
    launches = topl_scan.adc_scan_topl_cuda.launches
    allocated = torch.cuda.memory_allocated(cuda_device)
    with pytest.raises(ValueError, match="232448 B"):
        topl_scan.adc_scan_topl_cuda(codes, luts, bias, topl=16_385,
                                     num_queries=8)
    with pytest.raises(ValueError, match="shared memory"):
        ops.adc_scan_topl(codes, luts, topl=16_385, bias=bias)
    assert topl_scan.adc_scan_topl_cuda.launches == launches
    assert torch.cuda.memory_allocated(cuda_device) == allocated
    with pytest.raises(ValueError, match="scale"):
        topl_scan.adc_scan_topl_cuda(codes, luts.to(torch.int8), bias,
                                     topl=5, num_queries=8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,m,k", [(1_000_003, 13, 8, 256),
                                     (5_000, 1, 16, 256), (777, 9, 3, 70),
                                     (100, 3, 32, 256)])
def test_adc_scan_kernels_match_plain(cuda_device, n, q, m, k):
    rng = np.random.default_rng(n + q)
    codes = torch.as_tensor(rng.integers(0, k, (n, m)).astype(np.uint8))
    luts = torch.as_tensor(rng.normal(size=(q, m, k)).astype(np.float32))
    want_b = ref.adc_scan_batch_ref(codes, luts)
    want_1 = ref.adc_scan_ref(codes, luts[q - 1])
    launches = (adc_scan.adc_scan_cuda.launches,
                adc_scan.adc_scan_batch_cuda.launches)
    got_b = ops.adc_scan_batch(codes.to(cuda_device), luts.to(cuda_device))
    got_1 = ops.adc_scan(codes.to(cuda_device), luts[q - 1].to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got_b.cpu(), want_b)
    assert torch.equal(got_1.cpu(), want_1)
    assert (adc_scan.adc_scan_cuda.launches,
            adc_scan.adc_scan_batch_cuda.launches) == \
        (launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
def test_quantize_luts_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    luts = rng.normal(size=(64, 8, 256)) * np.exp(rng.uniform(-30, 30,
                                                              (64, 8, 1)))
    luts = torch.as_tensor(luts.astype(np.float32))
    # rows whose raw span is exactly a power of two, and one ulp above
    for i, k in enumerate(range(-30, 2)):
        span = torch.tensor(254.0 * 2.0 ** k, dtype=torch.float32)
        if i % 2:
            span = torch.nextafter(span, torch.tensor(float("inf")))
        luts[i, 0] = torch.linspace(0, 1, 256) * span
        luts[i, 0, -1] = span
    for lut_dtype in ("float16", "int8"):
        want = lut_quant.quantize_luts(luts, lut_dtype)
        got = lut_quant.quantize_luts(luts.to(cuda_device), lut_dtype)
        assert torch.equal(got[0].cpu(), want[0])
        if lut_dtype == "int8":
            assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["PQ8x256,Rerank100",
                                  "OPQ8x256,Rerank100,Scan(onehot)"])
def test_quantized_and_materialized_search_on_the_card(cuda_device, spec,
                                                       tmp_path):
    """f16 / i8 searches (streaming backend) or the materialized onehot
    backend on the card against the same index on the CPU."""
    ds = descriptors.make_synthetic_dataset(
        "deep", n_train=4000, n_base=20_000, n_query=64, n_centers=64,
        seed=5, compute_gt=False)
    gpu = index_factory(spec, dim=96, device=cuda_device)
    gpu.train(ds.train, outer_iters=2, kmeans_iters=5).add(ds.base)
    gpu.save(tmp_path / "index")
    cpu = Index.load(tmp_path / "index", device="cpu")
    assert cpu.backend == ("onehot" if "onehot" in spec else "torch")
    requests = [{}] if "onehot" in spec else \
        [{"lut_dtype": "float16", "overfetch": 2},
         {"lut_dtype": "int8", "overfetch": 3}]
    launches = (topl_scan.adc_scan_topl_cuda.launches,
                adc_scan.adc_scan_batch_cuda.launches)
    for kw in requests:
        luts = cpu._build_luts(torch.as_tensor(ds.queries))
        d2c, candc = candidate_generator_for("cpu", cpu.backend).topl(
            cpu.codes, luts, None, topl=100, **kw)
        d2g, candg = candidate_generator_for(cuda_device, gpu.backend).topl(
            gpu.codes, luts.to(cuda_device), None, topl=100, **kw)
        torch.cuda.synchronize()
        assert torch.equal(d2g.cpu(), d2c) and torch.equal(candg.cpu(), candc)
        want = cpu.search(ds.queries, 10, **kw)
        got = [x.cpu() for x in gpu.search(ds.queries, 10, **kw)]
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
        apart = torch.ones_like(want[1], dtype=torch.bool)
        gap = (want[0][:, 1:] - want[0][:, :-1]).abs() > 1e-4
        apart[:, 1:] &= gap
        apart[:, :-1] &= gap
        assert torch.equal(got[1][apart], want[1][apart])
    if "onehot" in spec:
        assert adc_scan.adc_scan_batch_cuda.launches > launches[1]
        with pytest.raises(ValueError, match="quantized_lut"):
            gpu.search(ds.queries, 10, lut_dtype="int8")
    else:
        assert topl_scan.adc_scan_topl_cuda.launches > launches[0]
