"""Synthetic Deep1M/BigANN1M-like descriptors + exact ground truth.

A numpy copy of ``repro/data/descriptors.py``: the same seed gives the
same arrays, bit for bit, because generation is numpy in both packages.
``exact_knn`` runs in torch on the given device. See the reference
module for how the synthetic distributions were calibrated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class DescriptorDataset:
    train: np.ndarray     # (n_train, D) learning set
    base: np.ndarray      # (n_base, D)  database to compress
    queries: np.ndarray   # (n_query, D) held-out queries
    gt_nn: np.ndarray     # (n_query,)   true NN of each query in `base`
    name: str = "synthetic"

    @property
    def dim(self) -> int:
        return self.train.shape[1]


_NOISE_SIGMA = 0.9
_TEXTURE_SIGMA = 0.55     # relative to the unit-norm descriptor


def _deep_like(rng: np.random.Generator, n: int, dim: int, latent: int,
               centers: np.ndarray, w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
    z = centers[rng.integers(0, len(centers), n)] + rng.normal(
        0, _NOISE_SIGMA, (n, latent))
    h = np.maximum(z @ w1, 0.0)
    x = h @ w2
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    x = x + rng.normal(0, _TEXTURE_SIGMA / np.sqrt(dim), (n, dim))
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    return x.astype(np.float32)


def _sift_like(rng: np.random.Generator, n: int, dim: int, latent: int,
               centers: np.ndarray, w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
    z = centers[rng.integers(0, len(centers), n)] + rng.normal(
        0, _NOISE_SIGMA, (n, latent))
    h = np.maximum(z @ w1, 0.0)
    x = np.abs(h @ w2)
    scale = np.mean(x)
    x = np.abs(x + rng.normal(0, _TEXTURE_SIGMA * scale, (n, dim)))
    x = np.minimum(x ** 1.5 * 25.0, 255.0)
    return x.astype(np.float32)


def make_synthetic_dataset(kind: str = "deep", *, dim: int | None = None,
                           n_train: int = 20_000, n_base: int = 50_000,
                           n_query: int = 1_000, n_centers: int = 512,
                           latent: int = 24, seed: int = 0,
                           compute_gt: bool = True,
                           device: str | torch.device = "cuda"
                           ) -> DescriptorDataset:
    """Build a Deep1M/BigANN1M-like synthetic dataset. ``device`` is where
    the ground-truth scan runs (only used when ``compute_gt``)."""
    if dim is None:
        dim = 96 if kind == "deep" else 128
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, (n_centers, latent))
    w1 = rng.normal(0, 1.0 / np.sqrt(latent), (latent, 4 * latent))
    w2 = rng.normal(0, 1.0 / np.sqrt(4 * latent), (4 * latent, dim))
    gen = _deep_like if kind == "deep" else _sift_like
    train = gen(rng, n_train, dim, latent, centers, w1, w2)
    base = gen(rng, n_base, dim, latent, centers, w1, w2)
    queries = gen(rng, n_query, dim, latent, centers, w1, w2)
    gt = exact_knn(queries, base, k=1, device=device)[:, 0] if compute_gt \
        else np.zeros((n_query,), np.int64)
    return DescriptorDataset(train, base, queries, gt,
                             name=f"{kind}{n_base // 1000}k")


def exact_knn(queries, base, k: int, batch: int = 256, *,
              device: str | torch.device = "cuda") -> np.ndarray:
    """Exact top-k neighbours by L2, chunked over queries: (Q, k) int64
    indices. Ties go to the smaller base index (``lax.top_k``'s order)."""
    device = resolve_device(device)
    base_t = torch.as_tensor(np.asarray(base, np.float32), device=device)
    base_sq = (base_t * base_t).sum(dim=1)
    q_all = torch.as_tensor(np.asarray(queries, np.float32), device=device)
    outs = []
    for s in range(0, q_all.shape[0], batch):
        qb = q_all[s:s + batch]
        d = ((qb * qb).sum(dim=1)[:, None] - 2.0 * qb @ base_t.T
             + base_sq[None, :])
        idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
        outs.append(idx.cpu().numpy())
    return np.concatenate(outs, axis=0)
