"""The port's model, data, checkpoint and config modules against the JAX
reference, plus the port's standing rules: it imports nothing of JAX or
of the reference package, and its default device raises without a card.

Float reductions (the MLPs, the d_c contractions) run in another order
in the two packages, so they are compared with allclose (rtol 1e-5,
atol 1e-5, far above fp32 rounding of these 32-1024-term sums and far
below any real difference); data generation is numpy in both and must
be identical.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs import unq_paper as jpaper
from repro.core import unq as junq
from repro.data import descriptors as jdata
from repro.utils.pytree import tree_flatten_with_names as j_names
from repro_torch.checkpoint import manager
from repro_torch.configs import unq_paper
from repro_torch.core import unq
from repro_torch.data import descriptors
from repro_torch.utils.pytree import tree_flatten_with_names

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = {"rtol": 1e-5, "atol": 1e-5}


def _jax_tree(tree):
    """The same nesting with jnp leaves (what the reference holds)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree)


# -- utils/pytree + checkpoint ---------------------------------------------------

def test_tree_names_match_reference():
    tree = {"z": [np.ones(2), {"b": np.zeros(1), "a": np.ones(3)}],
            "a": {"w": np.ones(1), "skip": None}, "m": (np.ones(1),)}
    got = tree_flatten_with_names(tree)
    want = j_names(tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [n for n, _ in got] == ["a/w", "m/0", "z/0", "z/1/a", "z/1/b"]


def test_unq_tree_names_match_reference():
    params, state = unq.numpy_params(unq_paper.SMOKE, 0)
    tree = {"params": params, "state": state, "codes": np.zeros((0, 4))}
    assert [n for n, _ in tree_flatten_with_names(tree)] == \
        [n for n, _ in j_names(_jax_tree(tree))]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_format_is_shared(tmp_path, writer):
    rng = np.random.default_rng(0)
    tree = {"b": [rng.normal(size=(3, 2)).astype(np.float32)],
            "a": {"codes": rng.integers(0, 255, (5, 4)).astype(np.uint8)}}
    path = tmp_path / "ckpt"
    if writer == "port":
        manager.save_pytree(path, {"b": [torch.as_tensor(tree["b"][0])],
                                   "a": tree["a"]}, metadata={"x": 1})
        got, man = jmanager.load_pytree(path, _jax_tree(tree))
    else:
        jmanager.save_pytree(path, _jax_tree(tree), metadata={"x": 1})
        got, man = manager.load_pytree(path, tree)
    assert man["metadata"] == {"x": 1}
    np.testing.assert_array_equal(np.asarray(got["b"][0]), tree["b"][0])
    codes = np.asarray(got["a"]["codes"])
    assert codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, tree["a"]["codes"])


def test_checkpoint_structure_mismatch_raises(tmp_path):
    manager.save_pytree(tmp_path / "c", {"a": np.ones(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        manager.load_pytree(tmp_path / "c", {"b": np.ones(2)})


# -- configs ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["DEEP_8B", "DEEP_16B", "SMOKE"])
def test_configs_match_reference(name):
    want = {k: v for k, v in dataclasses.asdict(getattr(jpaper, name)).items()
            if k != "dtype"}
    assert dataclasses.asdict(getattr(unq_paper, name)) == want


# -- core/unq ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    cfg = unq_paper.SMOKE
    params, state = unq.numpy_params(cfg, 3, bn_stats=True)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, cfg.dim)).astype(np.float32)
    codes = rng.integers(0, cfg.codebook_size,
                         (40, cfg.num_codebooks)).astype(np.uint8)
    return cfg, params, state, x, codes


def test_unq_from_jax_matches_reference(smoke_model):
    """The same weights in both packages: heads, LUTs (-logits) and
    decodes agree within fp32 rounding."""
    cfg, params, state, x, codes = smoke_model
    jcfg = junq.UNQConfig(**dataclasses.asdict(cfg))
    jp, js = _jax_tree(params), _jax_tree(state)
    model = unq.unq_from_jax(params, state, cfg)
    with torch.no_grad():
        heads = model.encode_heads(torch.as_tensor(x))
        logits = model.head_logits(heads)
        recon = model.decode_codes(torch.as_tensor(codes))
        cw = model.codewords_for_codes(torch.as_tensor(codes))
    jheads, _ = junq.encode_heads(jp, js, jcfg, jnp.asarray(x), train=False)
    np.testing.assert_allclose(heads.numpy(), np.asarray(jheads), **TOL)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(junq.head_logits(jp, jheads)),
                               **TOL)
    np.testing.assert_allclose(
        recon.numpy(),
        np.asarray(junq.decode_codes(jp, js, jcfg, jnp.asarray(codes))),
        **TOL)
    np.testing.assert_array_equal(
        cw.numpy(), np.asarray(junq.codewords_for_codes(jp,
                                                        jnp.asarray(codes))))


def test_unq_to_jax_round_trips(smoke_model):
    cfg, params, state, _, _ = smoke_model
    back_p, back_s = unq.unq_to_jax(unq.unq_from_jax(params, state, cfg))
    for (n1, a), (n2, b) in zip(
            tree_flatten_with_names({"p": params, "s": state}),
            tree_flatten_with_names({"p": back_p, "s": back_s}),
            strict=True):
        assert n1 == n2
        np.testing.assert_array_equal(a, b, err_msg=n1)


def test_batchnorm_uses_reference_eval_formula(smoke_model):
    cfg, params, state, _, _ = smoke_model
    model = unq.unq_from_jax(params, state, cfg)
    bn = model.encoder.bn[0]
    x = torch.linspace(-2, 2, cfg.hidden_dim)[None, :]
    want = (x - bn.mean) * torch.rsqrt(bn.var + 1e-5) * bn.scale + bn.bias
    assert torch.equal(bn(x), want)


def test_init_draws_reference_shapes_and_scales():
    cfg = unq_paper.SMOKE.with_(hidden_dim=512, code_dim=128)
    model = unq.init(cfg, torch.Generator().manual_seed(0))
    jparams, _ = jax.eval_shape(
        lambda key: junq.init(key, junq.UNQConfig(**dataclasses.asdict(cfg))),
        jax.random.PRNGKey(0))
    ours, _ = unq.unq_to_jax(model)
    for (n, a), (_, b) in zip(tree_flatten_with_names(ours),
                              j_names(jparams), strict=True):
        assert a.shape == tuple(b.shape), n
    w = model.encoder.layers[1].weight
    assert abs(w.std().item() - np.sqrt(2.0 / 512)) < 0.05 * np.sqrt(2 / 512)
    assert abs(model.codebooks.std().item() - 1 / np.sqrt(128)) < 0.01
    same = unq.init(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(same.codebooks, model.codebooks)


# -- data ---------------------------------------------------------------------------

def test_synthetic_dataset_identical_to_reference():
    kw = dict(n_train=300, n_base=500, n_query=20, n_centers=16, seed=5)
    ours = descriptors.make_synthetic_dataset("deep", device="cpu", **kw)
    ref = jdata.make_synthetic_dataset("deep", **kw)
    for field in ("train", "base", "queries"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field), err_msg=field)
    np.testing.assert_array_equal(ours.gt_nn, ref.gt_nn)
    sift = descriptors.make_synthetic_dataset("sift", compute_gt=False, **kw)
    np.testing.assert_array_equal(
        sift.base, jdata.make_synthetic_dataset("sift", compute_gt=False,
                                                **kw).base)


def test_exact_knn_matches_reference():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(400, 16)).astype(np.float32)
    queries = rng.normal(size=(30, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        descriptors.exact_knn(queries, base, k=5, batch=7, device="cpu"),
        jdata.exact_knn(queries, base, k=5))


# -- the port's standing rules ------------------------------------------------------

def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"the port must not import JAX or repro: {bad}"


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from repro_torch.index import index_factory, resolve_scan_backend
    from repro_torch.utils.device import resolve_device
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        index_factory("UNQ8x256,Rerank500", dim=96)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_scan_backend("auto")
    with pytest.raises(RuntimeError, match="cuda"):
        descriptors.exact_knn(np.ones((1, 2)), np.ones((3, 2)), k=1)
    assert resolve_scan_backend("auto", "cpu") == "torch"


def test_tf32_is_off():
    import repro_torch  # noqa: F401 — the package pins the flags
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
