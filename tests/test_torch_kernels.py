"""The port's kernels package against the JAX reference.

Stage 1 (``adc_scan_topl``): the port's plain stream and torch oracle
must equal the reference bit for bit in (score, id), ties included:
the reference's Pallas kernel (interpret mode on the CPU), its chunked
xla stream, and its ``ref`` oracles, on the same codes and LUTs.

``unq_encode`` is an argmax over d_c-long dot products whose summation
order differs between the packages, so codes must be equal wherever the
top-2 score gap exceeds 1e-5 of the row's largest |score| (rounding of a
32-term fp32 dot product is ~1e-7 of that scale).

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import merge, ops, ref, topl_scan, unq_encode

ENCODE_GAP_RTOL = 1e-5


def _scan_case(seed, n, m, k, q, tie_heavy):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    if tie_heavy:
        luts = rng.integers(-2, 3, (q, m, k)).astype(np.float32)
    else:
        luts = rng.normal(size=(q, m, k)).astype(np.float32)
    return rng, codes, luts


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assert_pairs_equal(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]),
                                  err_msg=f"scores {msg}")
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]),
                                  err_msg=f"ids {msg}")


# -- stage 1: adc_scan_topl --------------------------------------------------

@pytest.mark.parametrize("n,L,tie_heavy,filtered", [
    (1000, 37, False, False),      # N not a multiple of any tile
    (1000, 37, True, False),       # tie-heavy integer LUTs
    (257, 300, True, False),       # L > N (clamped to N)
    (2000, 64, False, True),       # (Q, N) qbias filter
    (1999, 50, True, True),        # ties + filter + ragged N
    (1, 1, False, False),          # degenerate
])
def test_adc_scan_topl_matches_reference(n, L, tie_heavy, filtered):
    rng, codes, luts = _scan_case(n + L, n, 8, 64, 5, tie_heavy)
    bias = rng.integers(-1, 2, (n,)).astype(np.float32)
    qbias = None
    if filtered:     # the lowered (Q, N) filter: 0 keeps, +inf drops
        qbias = np.where(rng.random((5, n)) < 0.97, 0.0,
                         np.inf).astype(np.float32)
    want = jref.adc_scan_topl_q_ref(
        jnp.asarray(codes), jnp.asarray(luts), None, jnp.asarray(bias), L,
        None if qbias is None else jnp.asarray(qbias))
    got = ops.adc_scan_topl(_t(codes), _t(luts), topl=L, bias=_t(bias),
                            qbias=None if qbias is None else _t(qbias))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_pairs_equal(got, want, "plain stream vs JAX oracle")
    _assert_pairs_equal(
        ref.adc_scan_topl_ref(_t(codes), _t(luts), _t(bias), L,
                              None if qbias is None else _t(qbias)),
        want, "torch oracle vs JAX oracle")
    jax_xla = jops.adc_scan_topl(
        jnp.asarray(codes), jnp.asarray(luts), topl=L, bias=jnp.asarray(bias),
        qbias=None if qbias is None else jnp.asarray(qbias), impl="xla")
    _assert_pairs_equal(got, jax_xla, "plain stream vs JAX xla stream")


def test_adc_scan_topl_matches_jax_pallas_kernel():
    """The reference's fused Pallas kernel (interpret mode) and the
    port's plain stream on the same tie-heavy, filtered inputs, where
    some queries keep fewer than L points: identical bits."""
    n, L, q = 1500, 48, 9
    rng, codes, luts = _scan_case(7, n, 4, 32, q, tie_heavy=True)
    keep = rng.random((q, n)) < np.linspace(0.01, 0.5, q)[:, None]
    qbias = np.where(keep, 0.0, np.inf).astype(np.float32)
    want = jops.adc_scan_topl(
        jnp.asarray(codes), jnp.asarray(luts), topl=L,
        qbias=jnp.asarray(qbias), impl="pallas", block_n=256, block_q=8)
    got = ops.adc_scan_topl(_t(codes), _t(luts), topl=L, qbias=_t(qbias))
    assert np.isinf(np.asarray(want[0])).any()
    _assert_pairs_equal(got, want, "plain stream vs JAX Pallas kernel")


@pytest.mark.parametrize("chunk_n", [1, 7, 64, 4096])
def test_adc_scan_topl_stream_chunking_is_exact(chunk_n):
    """Any chunk width of the plain stream gives the oracle's bits, with
    padded rows past ``n_valid`` never surfacing."""
    _, codes, luts = _scan_case(3, 300, 4, 16, 3, tie_heavy=True)
    bias = torch.zeros(300)
    want = ref.adc_scan_topl_ref(_t(codes[:290]), _t(luts), None, 20)
    got = topl_scan.adc_scan_topl_stream(_t(codes), _t(luts), bias,
                                         topl=20, n_valid=290,
                                         chunk_n=chunk_n)
    _assert_pairs_equal(got, want, f"chunk_n={chunk_n}")


@pytest.mark.parametrize("seed", [0, 1])
def test_adc_scan_refs_bitwise_vs_jax(seed):
    _, codes, luts = _scan_case(seed, 333, 8, 256, 4, tie_heavy=False)
    np.testing.assert_array_equal(
        ref.adc_scan_ref(_t(codes), _t(luts[0])).numpy(),
        np.asarray(jref.adc_scan_ref(jnp.asarray(codes),
                                     jnp.asarray(luts[0]))))
    np.testing.assert_array_equal(
        ref.adc_scan_batch_ref(_t(codes), _t(luts)).numpy(),
        np.asarray(jref.adc_scan_batch_ref(jnp.asarray(codes),
                                           jnp.asarray(luts))))


def test_quantized_luts_raise_naming_roadmap():
    # the quantized stage 1 is ported (ROADMAP A6 is closed); what it
    # still refuses raises as the reference does
    _, codes, luts = _scan_case(0, 10, 2, 4, 1, tie_heavy=False)
    with pytest.raises(ValueError, match="unknown lut_dtype"):
        ops.adc_scan_topl(_t(codes), _t(luts), topl=3, lut_dtype="bfloat16")
    with pytest.raises(ValueError, match="overfetch must be >= 1"):
        ops.adc_scan_topl(_t(codes), _t(luts), topl=3, lut_dtype="int8",
                          overfetch=0)


# -- the exact lexicographic merge -------------------------------------------

def _lexsort_prefix(s, g, topl):
    order = np.lexsort((g, s), axis=-1)
    return (np.take_along_axis(s, order, -1)[:, :topl],
            np.take_along_axis(g, order, -1)[:, :topl])


@pytest.mark.parametrize("heap_w,block_w,topl", [(1, 2, 4), (8, 8, 8),
                                                 (16, 5, 12), (3, 40, 20)])
def test_merge_matches_lexsort(heap_w, block_w, topl):
    """The port's merge against a lexsort oracle, including the widths
    where the reference's bitonic merge emits pad columns (topl >
    heap_w + block_w), ties, +inf entries and signed zeros."""
    rng = np.random.default_rng(heap_w * 100 + block_w)
    rows = 6
    gids = np.stack([rng.permutation(1000)[:heap_w + block_w]
                     for _ in range(rows)]).astype(np.int32)
    vals = rng.integers(-2, 3, (rows, heap_w + block_w)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = np.inf
    vals[vals == 0] = np.where(rng.random(int((vals == 0).sum())) < 0.5,
                               -0.0, 0.0)
    hs, hg = _lexsort_prefix(vals[:, :heap_w], gids[:, :heap_w], heap_w)
    want_s, want_g = _lexsort_prefix(vals, gids, topl)
    got_s, got_g = merge.merge_topl_pairs(
        _t(hs), _t(hg), _t(vals[:, heap_w:]), _t(gids[:, heap_w:]), topl)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_g.numpy(), want_g)


# -- unq_encode ----------------------------------------------------------------

def _near_ties(heads, books):
    """(B, M) True where the top-2 scores are within rounding."""
    s = np.einsum("bmd,mkd->bmk", heads.astype(np.float64),
                  books.astype(np.float64))
    top2 = np.sort(s, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= \
        ENCODE_GAP_RTOL * np.abs(s).max(axis=-1)


@pytest.mark.parametrize("b,m,k,d", [(300, 4, 64, 32), (64, 8, 256, 16),
                                     (5, 2, 100, 24)])
def test_unq_encode_matches_reference(b, m, k, d):
    rng = np.random.default_rng(b + k)
    heads = rng.normal(size=(b, m, d)).astype(np.float32)
    books = rng.normal(size=(m, k, d)).astype(np.float32)
    want = np.asarray(jref.unq_encode_ref(jnp.asarray(heads),
                                          jnp.asarray(books)))
    decided = ~_near_ties(heads, books)
    assert decided.mean() > 0.99
    for name, got in (
            ("plain", ops.unq_encode(_t(heads), _t(books))),
            ("torch oracle", ref.unq_encode_ref(_t(heads), _t(books)))):
        assert got.dtype == torch.int32 and tuple(got.shape) == (b, m)
        np.testing.assert_array_equal(got.numpy()[decided], want[decided],
                                      err_msg=name)


def test_unq_encode_matches_jax_pallas_kernel():
    rng = np.random.default_rng(11)
    heads = rng.normal(size=(300, 4, 32)).astype(np.float32)
    books = rng.normal(size=(4, 64, 32)).astype(np.float32)
    want = np.asarray(jops.unq_encode(jnp.asarray(heads), jnp.asarray(books),
                                      impl="pallas"))
    decided = ~_near_ties(heads, books)
    got = ops.unq_encode(_t(heads), _t(books)).numpy()
    np.testing.assert_array_equal(got[decided], want[decided])


def test_unq_encode_first_max_wins_across_tiles():
    """Exact ties across and within K tiles go to the smallest k."""
    heads = torch.ones((2, 1, 4))
    books = torch.zeros((1, 200, 4))
    books[0, [70, 150, 199], :] = 1.0        # tie across tiles: k=70 wins
    books[0, 3, :] = 0.5
    assert unq_encode.unq_encode_plain(heads, books).tolist() == [[70], [70]]
    books[0, 65, :] = 1.0                    # same tile, earlier: k=65
    assert ops.unq_encode(heads, books).tolist() == [[65], [65]]


def test_cpu_dispatch_never_launches_a_kernel():
    _, codes, luts = _scan_case(0, 50, 2, 4, 3, tie_heavy=False)
    before = (topl_scan.adc_scan_topl_cuda.launches,
              unq_encode.unq_encode_cuda.launches)
    ops.adc_scan_topl(_t(codes), _t(luts), topl=5)
    ops.unq_encode(torch.ones((3, 2, 4)), torch.ones((2, 5, 4)))
    assert (topl_scan.adc_scan_topl_cuda.launches,
            unq_encode.unq_encode_cuda.launches) == before
