"""The flat UNQ index of the port against the JAX reference, end to end
on the CPU: the same numpy weights and data go through
``repro.index.UNQIndex`` and ``repro_torch.index.UNQIndex``.

  * ``add``: codes equal wherever the top-2 codeword scores differ by
    more than 1e-5 of the row's largest |score| (the argmax is over
    dot products summed in another order);
  * stage 1: (d2, ids) bit-identical when both sides get the same codes
    and LUTs, with and without filter streams;
  * search: final D allclose (rtol 1e-5, atol 1e-5: fp32 rounding of the
    decoder MLP and the 32-term distance), and final ids equal wherever
    a distance differs from its neighbours by more than that tolerance;
  * save/load across the two packages, both ways.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unq as junq
from repro.index import Index as JIndex
from repro.index import candidate_generator_for as j_generator
from repro.index.unq_index import UNQIndex as JUNQIndex
from repro.index.unq_index import build_luts as j_build_luts
from repro.kernels import ref as jref_oracle
from repro_torch.configs.unq_paper import SMOKE
from repro_torch.core import unq
from repro_torch.data import descriptors
from repro_torch.index import rerank
from repro_torch.index import (DedupRerank, Index, UNQIndex, VmapRerank,
                               backend_capabilities, backend_supports,
                               candidate_generator_for, index_factory,
                               merge_topl, resolve_scan_backend,
                               reranker_for)

TOL = {"rtol": 1e-5, "atol": 1e-5}
ENCODE_GAP_RTOL = 1e-5
K_FINAL, RERANK = 10, 50


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    """One set of numpy weights and data, loaded into both packages; the
    reference index is built and filled once."""
    cfg = SMOKE
    ds = descriptors.make_synthetic_dataset(
        "deep", dim=cfg.dim, n_train=500, n_base=2000, n_query=16,
        n_centers=32, seed=1, compute_gt=False)
    params, state = unq.numpy_params(cfg, 0, bn_stats=True, center=ds.train)
    jcfg = junq.UNQConfig(**dataclasses.asdict(cfg))
    jref = JUNQIndex.from_trained(_jax_tree(params), _jax_tree(state), jcfg,
                                  rerank=RERANK, backend="xla")
    jref.add(ds.base)
    rng = np.random.default_rng(2)
    masks = {None: None,
             "shared": rng.random(2000) < 0.6,
             "per_query": rng.random((16, 2000)) < 0.004}
    return cfg, params, state, ds, jref, masks


def _port_index(setup, codes=None):
    cfg, params, state, _, jref, _ = setup
    return UNQIndex.from_trained(unq.unq_from_jax(params, state, cfg),
                                 codes=codes, rerank=RERANK, device="cpu")


def _assert_search_close(got, want):
    """D allclose; ids equal wherever a distance is apart from its
    neighbours by more than the tolerance. A run of near-equal distances
    (often exactly equal: points with identical codes) must hold the
    same ids as a set, unless the top-k cut splits it; the filtered
    (-1, +inf) tails must be equal exactly."""
    d, i = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    assert d.shape == wd.shape and i.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(d[fin], wd[fin], **TOL)
    np.testing.assert_array_equal(i[~fin], wi[~fin])
    checked = 0
    for row in range(wd.shape[0]):
        pos = np.flatnonzero(fin[row])
        r = wd[row, pos]
        apart = np.abs(np.diff(r)) > TOL["atol"] + TOL["rtol"] * np.abs(r[1:])
        for run in np.split(pos, np.flatnonzero(apart) + 1):
            if len(run) == 0 or (len(run) > 1 and run[-1] == wd.shape[1] - 1):
                continue                  # a tie run cut by the top-k
            np.testing.assert_array_equal(np.sort(i[row, run]),
                                          np.sort(wi[row, run]))
            checked += len(run)
    assert checked >= 0.5 * fin.sum()


# -- add ------------------------------------------------------------------------

def test_add_codes_match_reference(setup):
    cfg, params, state, ds, jref, _ = setup
    index = _port_index(setup)
    index.add(ds.base[:700]).add(ds.base[700:])
    assert index.ntotal == 2000 and index.codes.dtype == torch.uint8
    jheads, _ = junq.encode_heads(jref.params, jref.state, jref.cfg,
                                  jnp.asarray(ds.base), train=False)
    s = np.einsum("bmd,mkd->bmk", np.asarray(jheads, np.float64),
                  params["codebooks"].astype(np.float64))
    top2 = np.sort(s, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > \
        ENCODE_GAP_RTOL * np.abs(s).max(axis=-1)
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(index.codes.numpy()[decided],
                                  np.asarray(jref.codes)[decided])


def test_add_bucket_padding_is_row_stable(setup):
    """Adding in chunks that pad to different ENCODE_BUCKETS gives the
    codes of one add."""
    ds = setup[3]
    whole = _port_index(setup).add(ds.base)
    parts = _port_index(setup)
    for lo, hi in ((0, 1), (1, 256), (256, 1300), (1300, 2000)):
        parts.add(ds.base[lo:hi])
    assert torch.equal(parts.codes, whole.codes)
    assert Index._encode_bucket(1) == 256
    assert Index._encode_bucket(8193) == 16384


# -- stage 1 ---------------------------------------------------------------------

@pytest.mark.parametrize("mask", [None, "shared", "per_query"])
def test_stage1_bitwise_on_the_same_luts(setup, mask):
    _, _, _, ds, jref, masks = setup
    codes = np.asarray(jref.codes)
    luts = np.asarray(j_build_luts(jref.params, jref.state, jref.cfg,
                                   jnp.asarray(ds.queries)))
    jbias, jqbias = jref._lower_filter(masks[mask], 16)
    want = jref_oracle.adc_scan_topl_q_ref(
        jnp.asarray(codes), jnp.asarray(luts), None,
        jnp.zeros(2000) if jbias is None else jbias, RERANK, jqbias)
    index = _port_index(setup, codes=codes)
    bias, qbias = index._lower_filter(masks[mask], 16)
    got = candidate_generator_for("cpu").topl(
        index.codes, torch.tensor(luts), bias, topl=RERANK, qbias=qbias)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the reference's own streaming generator: identical wherever the
    # score is finite (its xla stream gives +inf entries the pad id
    # INT32_MAX where the oracle and its Pallas kernel keep the real id)
    stream = j_generator("xla").topl(jnp.asarray(codes), jnp.asarray(luts),
                                     jbias, topl=RERANK, qbias=jqbias)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(stream[0]))
    fin = np.isfinite(np.asarray(stream[0]))
    np.testing.assert_array_equal(got[1].numpy()[fin],
                                  np.asarray(stream[1])[fin])


# -- search ----------------------------------------------------------------------

@pytest.mark.parametrize("mask", [None, "shared", "per_query"])
@pytest.mark.parametrize("use_rerank", [True, False])
def test_search_matches_reference(setup, mask, use_rerank):
    """Both packages search the same database (the reference's codes)
    with the same weights."""
    _, _, _, ds, jref, masks = setup
    index = _port_index(setup, codes=np.asarray(jref.codes))
    want = jref.search(ds.queries, K_FINAL, use_rerank=use_rerank,
                       filter_mask=masks[mask])
    got = index.search(ds.queries, K_FINAL, use_rerank=use_rerank,
                       filter_mask=masks[mask])
    assert got[0].device.type == "cpu"
    _assert_search_close(got, want)
    if mask == "per_query":       # ~8 kept per query: rows run out
        assert (got[1].numpy() == -1).any()


@pytest.mark.parametrize("chunks", [None, (8, 7)])
def test_dedup_rerank_matches_materialized_oracle(setup, chunks,
                                                  monkeypatch):
    """At the default chunk sizes and at small ones that make the decode
    ladder and the distance loop take several steps."""
    if chunks is not None:
        monkeypatch.setattr(rerank, "DEDUP_DECODE_CHUNK", chunks[0])
        monkeypatch.setattr(rerank, "DEDUP_DIST_CHUNK", chunks[1])
    ds, jref = setup[3], setup[4]
    index = _port_index(setup, codes=np.asarray(jref.codes))
    assert isinstance(reranker_for(index), DedupRerank)
    queries = torch.as_tensor(ds.queries)
    cand = torch.as_tensor(np.random.default_rng(0).integers(
        0, 2000, (16, 40)), dtype=torch.int32)
    cand[:, 5] = cand[:, 6]                         # duplicate candidates
    np.testing.assert_allclose(
        DedupRerank().distances(index, queries, cand).numpy(),
        VmapRerank().distances(index, queries, cand).numpy(), **TOL)


# -- save / load across the packages ---------------------------------------------

def test_load_reference_saved_index(setup, tmp_path):
    ds, jref = setup[3], setup[4]
    jref.save(tmp_path / "jax_index")
    index = Index.load(tmp_path / "jax_index", device="cpu")
    assert isinstance(index, UNQIndex) and index.ntotal == 2000
    assert index.backend == "torch"       # the device picks it, not "xla"
    np.testing.assert_array_equal(index.codes.numpy(), np.asarray(jref.codes))
    _assert_search_close(index.search(ds.queries, K_FINAL),
                         jref.search(ds.queries, K_FINAL))


def test_reference_loads_port_saved_index(setup, tmp_path):
    ds, jref = setup[3], setup[4]
    index = _port_index(setup, codes=np.asarray(jref.codes))
    index.save(tmp_path / "torch_index")
    back = JIndex.load(tmp_path / "torch_index")
    assert isinstance(back, JUNQIndex) and back.ntotal == 2000
    np.testing.assert_array_equal(np.asarray(back.codes),
                                  np.asarray(jref.codes))
    want = jref.search(ds.queries, K_FINAL)
    got = back.search(ds.queries, K_FINAL)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    again = Index.load(tmp_path / "torch_index", device="cpu")
    for a, b in zip(again.search(ds.queries, K_FINAL),
                    index.search(ds.queries, K_FINAL)):
        assert torch.equal(a, b)


# -- factory, backends, what is not ported -------------------------------------------

def test_factory_builds_the_flat_unq_index():
    index = index_factory("UNQ8x256,Rerank500", dim=96, device="cpu")
    assert isinstance(index, UNQIndex) and index.rerank == 500
    assert (index.cfg.num_codebooks, index.cfg.codebook_size) == (8, 256)
    assert index_factory("UNQ16", dim=96, device="cpu").rerank == 500
    assert not index.is_trained


@pytest.mark.parametrize("spec,err,match", [
    ("RVQ8x256,Rerank200", NotImplementedError, "A5b"),
    ("RVQ8", NotImplementedError, "A5b"),
    ("IVF64,UNQ8x256", NotImplementedError, "A7"),
    ("UNQ8x256,NProbe4", NotImplementedError, "A7"),
    ("UNQ8x256,Scan(xla)", NotImplementedError, "device="),
    ("UNQ8x256,Bogus", ValueError, "cannot parse"),
    ("Rerank50", ValueError, "no quantizer"),
    ("UNQ8,UNQ16", ValueError, "multiple quantizers"),
])
def test_factory_rejects_what_is_not_ported(spec, err, match):
    with pytest.raises(err, match=match):
        index_factory(spec, dim=96, device="cpu")


def test_backend_registry():
    assert resolve_scan_backend("auto", "cpu") == "torch"
    assert resolve_scan_backend("torch", "cpu") == "torch"
    assert backend_capabilities("cuda") == {"streaming_topl", "fused_topl",
                                            "quantized_lut"}
    assert backend_supports("torch", "streaming_topl")
    assert backend_supports("torch", "quantized_lut")
    assert not backend_supports("torch", "fused_topl")
    assert resolve_scan_backend("onehot", "cpu") == "onehot"
    assert backend_capabilities("onehot") == frozenset()
    with pytest.raises(ValueError, match="runs on cuda"):
        resolve_scan_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown scan backend"):
        resolve_scan_backend("pallas", "cpu")


def test_unported_paths_raise_naming_roadmap(setup):
    ds, jref = setup[3], setup[4]
    index = _port_index(setup, codes=np.asarray(jref.codes))
    with pytest.raises(NotImplementedError, match="A3"):
        index.search(ds.queries, 5, use_d2=False)
    with pytest.raises(NotImplementedError, match="A4"):
        index.train(ds.base)
    gen = candidate_generator_for("cpu")
    for face in (gen.gather_topl, gen.dispatch_topl):
        with pytest.raises(NotImplementedError, match="A7"):
            face()


def test_merge_topl_canonicalizes_infinite_entries():
    s = torch.tensor([[3.0, float("inf"), 1.0, 3.0, float("inf")]])
    g = torch.tensor([[9, 4, 7, 2, 1]], dtype=torch.int32)
    got_s, got_g = merge_topl(s, g, 5)
    assert got_s.tolist() == [[1.0, 3.0, 3.0, float("inf"), float("inf")]]
    assert got_g.tolist() == [[7, 2, 9, 2**31 - 1, 2**31 - 1]]


def test_empty_index_and_untrained_add_raise():
    index = index_factory("UNQ4x64", dim=32, device="cpu")
    with pytest.raises(RuntimeError, match="before train"):
        index.add(np.zeros((3, 32), np.float32))
    with pytest.raises(RuntimeError, match="empty index"):
        UNQIndex.from_trained(unq.UNQ(SMOKE), device="cpu").search(
            np.zeros((1, 32), np.float32), 1)
