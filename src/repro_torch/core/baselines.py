"""Shallow MCQ baselines of the paper's comparison (Tables 2-4): PQ and OPQ.

The port of ``repro/core/baselines.py`` (k-means, ``PQModel``,
``train_pq``, ``train_opq``):

  * PQ  — Product Quantization (Jegou et al. 2011): k-means per subspace.
  * OPQ — Optimized PQ (Ge et al. 2013): alternate a Procrustes rotation
          and PQ codebooks (OPQ-NP).

All of it is plain PyTorch: the reference computes training, encoding
and LUTs outside any Pallas kernel too. Random draws come from an
explicit CPU ``torch.Generator``, so a device changes no draw; they are
not ``jax.random``'s bits, so tests start both packages' Lloyd loops
from the same centroids and compare whole trainings by recall.

``search_pq`` is the classic one-query-at-a-time ADC search over PQ
codes (``ops.adc_scan``, the materialized scan kernel on the card).
RVQ (``train_rvq``, ``RVQModel``, ``search_rvq``) waits for ROADMAP A5b,
the learned rerank decoder for A5c.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances in the reference's association:
    ``(|x|^2 - 2 x.c) + |c|^2``."""
    return ((x * x).sum(dim=1)[:, None] - 2.0 * (x @ cent.T)
            + (cent * cent).sum(dim=1)[None, :])


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row: (n, d), (k, d) -> (n,) int64, the
    first minimum winning."""
    return torch.argmin(_sq_dists(x, cent), dim=1)


def kmeans_init(x: torch.Tensor, k: int,
                generator: torch.Generator) -> torch.Tensor:
    """k initial centroids drawn from the rows of ``x``: distinct rows
    when there are at least k, else with replacement (the reference's
    ``jax.random.choice(key, n, (k,), replace=n < k)``)."""
    n = x.shape[0]
    if n >= k:
        idx = torch.randperm(n, generator=generator)[:k]
    else:
        idx = torch.randint(0, n, (k,), generator=generator)
    return x[idx.to(x.device)]


def lloyd(x: torch.Tensor, cent: torch.Tensor, iters: int,
          generator: torch.Generator) -> torch.Tensor:
    """``iters`` Lloyd steps from the centroids ``cent`` (k, d). Each step
    assigns every row to its nearest centroid and moves each centroid to
    the mean of its rows; a centroid left with no row is re-seeded from
    a row drawn at random, as in the reference's step. The sums are the
    reference's one-hot product, which, unlike an atomic scatter-add on
    the card, gives the same bits on every run."""
    n = x.shape[0]
    k = cent.shape[0]
    for _ in range(iters):
        assign = _assign(x, cent)
        onehot = x.new_zeros((n, k)).scatter_(1, assign[:, None], 1.0)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ x
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        reseed = x[torch.randint(0, n, (k,), generator=generator)
                   .to(x.device)]
        cent = torch.where(counts[:, None] > 0, new, reseed)
    return cent


def kmeans(x: torch.Tensor, k: int, iters: int = 25, *,
           generator: torch.Generator) -> torch.Tensor:
    """Lloyd's algorithm from ``kmeans_init``: (n, d) -> centroids (k, d)."""
    return lloyd(x, kmeans_init(x, k, generator), iters, generator)


# ---------------------------------------------------------------------------
# PQ / OPQ
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PQModel:
    """M sub-codebooks over consecutive D/M-wide slices of the (optionally
    rotated) space. OPQ's ``rotation`` R maps x to ``x @ R``."""

    codebooks: torch.Tensor                 # (M, K, D/M)
    rotation: torch.Tensor | None = None    # OPQ: (D, D)

    @property
    def num_books(self) -> int:
        return self.codebooks.shape[0]

    def _maybe_rotate(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.rotation if self.rotation is not None else x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) -> (N, M) uint8, one sub-codebook at a time."""
        x = self._maybe_rotate(x)
        m, _, d_sub = self.codebooks.shape
        xs = x.reshape(x.shape[0], m, d_sub)
        codes = torch.stack([_assign(xs[:, i], self.codebooks[i])
                             for i in range(m)], dim=1)
        return codes.to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(N, M) codes -> (N, D), back in the original space."""
        m, _, d_sub = self.codebooks.shape
        m_idx = torch.arange(m, device=codes.device)[None, :]
        cw = self.codebooks[m_idx, codes.long()]           # (N, M, d_sub)
        x = cw.reshape(codes.shape[0], m * d_sub)
        return x @ self.rotation.T if self.rotation is not None else x

    def lut(self, queries: torch.Tensor) -> torch.Tensor:
        """Squared-L2 distance tables: (Q, D) -> (Q, M, K); the reference's
        per-query ``lut`` with the batch written out."""
        q = self._maybe_rotate(queries)
        m, _, d_sub = self.codebooks.shape
        qs = q.reshape(q.shape[0], m, 1, d_sub)
        return torch.square(qs - self.codebooks[None]).sum(dim=-1)


def train_pq(train: torch.Tensor, num_books: int, book_size: int = 256,
             iters: int = 25, *, generator: torch.Generator) -> PQModel:
    """k-means of ``book_size`` centroids on each of the ``num_books``
    subspaces, in order, all drawing from ``generator``."""
    d = train.shape[1]
    if d % num_books:
        raise ValueError(f"dim {d} is not a multiple of num_books "
                         f"{num_books}")
    xs = train.reshape(train.shape[0], num_books, d // num_books)
    books = torch.stack([kmeans(xs[:, m].contiguous(), book_size, iters,
                                generator=generator)
                         for m in range(num_books)])
    return PQModel(books)


def procrustes(train: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """The orthogonal R minimizing ||train @ R - recon||_F: ``u @ vh`` of
    the SVD of ``train.T @ recon``. It does not depend on the signs the
    SVD picks for its singular vectors."""
    u, _, vh = torch.linalg.svd(train.T @ recon, full_matrices=False)
    return u @ vh


def train_opq(train: torch.Tensor, num_books: int, book_size: int = 256,
              outer_iters: int = 8, kmeans_iters: int = 10, *,
              generator: torch.Generator) -> PQModel:
    """OPQ-NP: ``outer_iters`` rounds of (PQ on the rotated data, then a
    Procrustes rotation towards its reconstructions), then a final PQ of
    25 Lloyd iterations on the data under the last rotation."""
    rot = torch.eye(train.shape[1], dtype=train.dtype, device=train.device)
    for _ in range(outer_iters):
        xr = train @ rot
        model = train_pq(xr, num_books, book_size, kmeans_iters,
                         generator=generator)
        recon = model.decode(model.encode(xr))          # rotated space
        rot = procrustes(train, recon)
    final = train_pq(train @ rot, num_books, book_size, iters=25,
                     generator=generator)
    final.rotation = rot
    return final


# ---------------------------------------------------------------------------
# Search with shallow models (shares the ADC scan with the indexes)
# ---------------------------------------------------------------------------

def search_pq(model: PQModel, queries: torch.Tensor, codes: torch.Tensor,
              topk: int) -> torch.Tensor:
    """Exhaustive ADC search: for each of the (Q, D) queries, one
    ``ops.adc_scan`` of its squared-L2 table over the (N, M) codes, then
    its ``topk`` smallest scores in ``lax.top_k``'s tie order (a stable
    sort: equal scores keep the lower index). Returns (Q, topk) int32
    row ids."""
    luts = model.lut(queries)                               # (Q, M, K)
    out = []
    for lut in luts:
        scores = ops.adc_scan(codes, lut)
        out.append(torch.sort(scores, stable=True).indices[:topk])
    return torch.stack(out).to(torch.int32)
