"""Unsupervised Neural Quantization (UNQ) model, inference side.

The port of ``repro/core/unq.py`` as an ``nn.Module``: an encoder MLP
``net(x)`` with M heads of ``d_c`` dims, codebooks ``C (M, K, d_c)``, a
per-codebook ``log_tau``, and a decoder MLP ``g`` that reconstructs x
from the SUM of the selected codewords. Each MLP is Linear -> BatchNorm
(eval) -> ReLU, ``num_hidden_layers`` times, then a Linear head.

Layout choice: linear layers are ``nn.Linear``, whose ``weight`` is
``(d_out, d_in)``; the JAX package stores ``w`` as ``(d_in, d_out)``
(``x @ w``), so ``unq_from_jax`` / ``unq_to_jax`` transpose it.

BatchNorm runs the reference's eval formula verbatim,
``(x - mean) * rsqrt(var + 1e-5) * scale + bias``, rather than
``nn.BatchNorm1d`` (which divides by ``sqrt``), so the two packages
round the same way up to the matmul order.

Training (Gumbel-softmax bottleneck, losses) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class UNQConfig:
    """Hyper-parameters of the UNQ model (paper §4.1 defaults). The field
    names are those of ``repro.core.unq.UNQConfig`` minus ``dtype``
    (float32 is the only one used), so saved-index metadata loads in
    both packages."""

    dim: int = 96              # D: descriptor dimensionality (Deep1M: 96)
    num_codebooks: int = 8     # M: bytes per vector (K=256 -> 1 byte/codebook)
    codebook_size: int = 256   # K
    code_dim: int = 256        # d_c: dimensionality of the learned spaces
    hidden_dim: int = 1024     # two 1024-unit hidden layers (paper §4.1)
    num_hidden_layers: int = 2
    init_temperature: float = 1.0
    bn_momentum: float = 0.9

    def with_(self, **kw) -> "UNQConfig":
        return dataclasses.replace(self, **kw)


class BatchNormEval(nn.Module):
    """BatchNorm over the batch axis in eval mode, with the reference's
    formula (``repro/core/unq.py::_bn_apply``)."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("mean", torch.zeros(d))
        self.register_buffer("var", torch.ones(d))

    def forward(self, x):
        inv = torch.rsqrt(self.var + 1e-5)
        return (x - self.mean) * inv * self.scale + self.bias


class MLP(nn.Module):
    """Linear -> BatchNorm(eval) -> ReLU (x n_hidden) -> Linear head."""

    def __init__(self, d_in: int, hidden: int, n_hidden: int, d_out: int):
        super().__init__()
        dims = [d_in] + [hidden] * n_hidden
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.bn = nn.ModuleList(BatchNormEval(hidden)
                                for _ in range(n_hidden))
        self.head = nn.Linear(dims[-1], d_out)

    def forward(self, x):
        for lin, bn in zip(self.layers, self.bn):
            x = torch.relu(bn(lin(x)))
        return self.head(x)


class UNQ(nn.Module):
    """The UNQ model (inference). A new one holds PyTorch's default
    parameters; ``init`` draws the reference's shapes and scales, and
    ``unq_from_jax`` loads the reference's weights."""

    def __init__(self, cfg: UNQConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = MLP(cfg.dim, cfg.hidden_dim, cfg.num_hidden_layers,
                           cfg.num_codebooks * cfg.code_dim)
        self.decoder = MLP(cfg.code_dim, cfg.hidden_dim,
                           cfg.num_hidden_layers, cfg.dim)
        self.codebooks = nn.Parameter(torch.empty(
            cfg.num_codebooks, cfg.codebook_size, cfg.code_dim))
        self.log_tau = nn.Parameter(torch.full(
            (cfg.num_codebooks,), math.log(cfg.init_temperature)))
        self.eval()

    def encode_heads(self, x):
        """``net(x)``: (B, D) -> (B, M, d_c)."""
        h = self.encoder(x)
        return h.reshape(x.shape[0], self.cfg.num_codebooks,
                         self.cfg.code_dim)

    def head_logits(self, heads):
        """Raw dot products ``<net(x)_m, c_mk>``: (B, M, d_c) -> (B, M, K)."""
        return torch.einsum("bmd,mkd->bmk", heads, self.codebooks)

    def codewords_for_codes(self, codes):
        """Gather selected codewords: codes (B, M) -> (B, M, d_c)."""
        m_idx = torch.arange(self.cfg.num_codebooks, device=codes.device)
        return self.codebooks[m_idx[None, :], codes.long()]

    def decode_codes(self, codes):
        """Decoder on integer codes (B, M) -> (B, D), eval mode."""
        return self.decoder(self.codewords_for_codes(codes).sum(dim=1))


# ---------------------------------------------------------------------------
# parameter init and the bridge to the reference's pytrees
# ---------------------------------------------------------------------------

def init(cfg: UNQConfig, generator: torch.Generator | None = None) -> UNQ:
    """A UNQ with the shapes and scales of ``repro/core/unq.py::init``:
    He-normal linear weights (std sqrt(2 / d_in)), zero biases, identity
    BatchNorm, codebooks N(0, 1/d_c), ``log_tau = log(init_temperature)``.
    The draws come from ``generator`` and differ from JAX's."""
    model = UNQ(cfg)
    with torch.no_grad():
        for mlp in (model.encoder, model.decoder):
            for lin in list(mlp.layers) + [mlp.head]:
                d_in = lin.weight.shape[1]
                lin.weight.normal_(0.0, math.sqrt(2.0 / d_in),
                                   generator=generator)
                lin.bias.zero_()
        model.codebooks.normal_(0.0, 1.0 / math.sqrt(cfg.code_dim),
                                generator=generator)
    return model


def numpy_params(cfg: UNQConfig, seed: int, *, bn_stats: bool = False,
                 center=None):
    """Reference-layout ``(params, state)`` nested dicts of numpy arrays
    drawn from ``np.random.default_rng(seed)`` with the shapes and scales
    of ``repro/core/unq.py::init`` — one set of weights both packages can
    load (``unq_from_jax`` here, as-is in JAX). ``bn_stats=True`` also
    draws non-trivial BatchNorm statistics and affine terms, so the
    eval-mode normalization is exercised rather than the identity.

    ``center`` (an (n, D) sample of the data) sets the encoder head's
    bias so the mean head over the sample is zero. A random ReLU encoder
    gives every head a large shared component, and the argmax then picks
    a few codewords for all points; centred heads spread the codes as a
    trained encoder does."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    def mlp(d_in, d_out):
        dims = [d_in] + [cfg.hidden_dim] * cfg.num_hidden_layers
        layers, bn_p, bn_s = [], [], []
        for a, b in zip(dims[:-1], dims[1:]):
            layers.append({"w": f32(rng.normal(0, np.sqrt(2.0 / a), (a, b))),
                           "b": f32(np.zeros(b))})
            if bn_stats:
                bn_p.append({"scale": f32(rng.uniform(0.5, 1.5, b)),
                             "bias": f32(rng.normal(0, 0.02, b))})
                bn_s.append({"mean": f32(rng.normal(0, 0.02, b)),
                             "var": f32(rng.uniform(0.5, 1.5, b))})
            else:
                bn_p.append({"scale": f32(np.ones(b)),
                             "bias": f32(np.zeros(b))})
                bn_s.append({"mean": f32(np.zeros(b)),
                             "var": f32(np.ones(b))})
        head = {"w": f32(rng.normal(0, np.sqrt(2.0 / dims[-1]),
                                    (dims[-1], d_out))),
                "b": f32(np.zeros(d_out))}
        return {"layers": layers, "bn": bn_p, "head": head}, {"bn": bn_s}

    enc_p, enc_s = mlp(cfg.dim, cfg.num_codebooks * cfg.code_dim)
    dec_p, dec_s = mlp(cfg.code_dim, cfg.dim)
    params = {
        "encoder": enc_p,
        "decoder": dec_p,
        "codebooks": f32(rng.normal(
            0, 1.0 / np.sqrt(cfg.code_dim),
            (cfg.num_codebooks, cfg.codebook_size, cfg.code_dim))),
        "log_tau": f32(np.full(cfg.num_codebooks,
                               np.log(cfg.init_temperature))),
    }
    state = {"encoder": enc_s, "decoder": dec_s}
    if center is not None:
        with torch.no_grad():
            heads = unq_from_jax(params, state, cfg).encoder(
                torch.as_tensor(np.asarray(center, np.float32)))
        enc_p["head"]["b"] = f32(-heads.mean(dim=0).numpy())
    return params, state


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _mlp_from_jax(mlp: MLP, params, state) -> None:
    for lin, p in zip(mlp.layers, params["layers"]):
        lin.weight.copy_(_t(p["w"]).T)
        lin.bias.copy_(_t(p["b"]))
    for bn, p, s in zip(mlp.bn, params["bn"], state["bn"]):
        bn.scale.copy_(_t(p["scale"]))
        bn.bias.copy_(_t(p["bias"]))
        bn.mean.copy_(_t(s["mean"]))
        bn.var.copy_(_t(s["var"]))
    mlp.head.weight.copy_(_t(params["head"]["w"]).T)
    mlp.head.bias.copy_(_t(params["head"]["b"]))


def unq_from_jax(params, state, cfg: UNQConfig) -> UNQ:
    """Build a (CPU) UNQ from the reference's ``(params, state)`` pytrees,
    given as nested dicts of numpy arrays (``np.asarray`` of JAX arrays
    works too). Linear weights are transposed to ``nn.Linear`` layout."""
    model = UNQ(cfg)
    with torch.no_grad():
        _mlp_from_jax(model.encoder, params["encoder"], state["encoder"])
        _mlp_from_jax(model.decoder, params["decoder"], state["decoder"])
        model.codebooks.copy_(_t(params["codebooks"]))
        model.log_tau.copy_(_t(params["log_tau"]))
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def _mlp_to_jax(mlp: MLP):
    params = {
        "layers": [{"w": _np(lin.weight.T), "b": _np(lin.bias)}
                   for lin in mlp.layers],
        "bn": [{"scale": _np(bn.scale), "bias": _np(bn.bias)}
               for bn in mlp.bn],
        "head": {"w": _np(mlp.head.weight.T), "b": _np(mlp.head.bias)},
    }
    state = {"bn": [{"mean": _np(bn.mean), "var": _np(bn.var)}
                    for bn in mlp.bn]}
    return params, state


def unq_to_jax(model: UNQ):
    """The inverse of ``unq_from_jax``: reference-layout ``(params,
    state)`` nested dicts of numpy arrays."""
    enc_p, enc_s = _mlp_to_jax(model.encoder)
    dec_p, dec_s = _mlp_to_jax(model.decoder)
    params = {"encoder": enc_p, "decoder": dec_p,
              "codebooks": _np(model.codebooks),
              "log_tau": _np(model.log_tau)}
    return params, {"encoder": enc_s, "decoder": dec_s}
