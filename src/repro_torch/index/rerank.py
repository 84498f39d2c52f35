"""Pluggable stage-2 reranking (the port of ``repro/index/rerank.py``).

``Index._rerank_distances`` (exact reconstruction distances d1, paper
Eq. 7, over each query's stage-1 candidates) delegates to a
``Reranker``:

  * ``TableRerank``  table-decodable quantizers (PQ / OPQ: ``recon =
                     sum_m table[m, code_m]``): the (Q, L, M) uint8
                     candidate codes are gathered and
                     ``ops.rerank_gather_dist`` decodes and reduces them
                     without a (Q, L, D) reconstruction: the fused
                     kernel on the card, the chunked plain version on
                     the CPU.
  * ``DedupRerank``  decoder quantizers (UNQ): the (Q * L) pool is
                     deduplicated on the device (``torch.unique``), each
                     unique code row is decoded once in fixed-size
                     batches, and distances are gathered back per
                     (query, candidate) in column chunks, so the held
                     reconstruction is (U, D), U = #unique, not (Q, L, D).
  * ``VmapRerank``   the materialized oracle: decode every (query,
                     candidate) pair, (Q, L, D). Kept as the test
                     reference only.

The residual-IVF wrapper arrives with its slice (ROADMAP A7).
"""
from __future__ import annotations

import abc

import torch

from repro_torch.kernels import ops

#: decode-batch ladder for DedupRerank (the smallest power-of-two bucket
#: >= the unique count serves small pools)
DEDUP_DECODE_CHUNK = 2048
#: L-chunk of the gathered-distance loop (the reference's
#: DEFAULT_RERANK_CHUNK_L)
DEDUP_DIST_CHUNK = 64


class Reranker(abc.ABC):
    """Stage-2 strategy: queries + candidate ids -> exact d1 distances."""

    @abc.abstractmethod
    def distances(self, index, queries, cand) -> torch.Tensor:
        """queries (Q, D), cand (Q, L) rows of ``index.codes`` -> d1
        (Q, L) f32, d1[q, l] = ||queries[q] - recon(cand[q, l])||^2."""

    def __repr__(self):
        return f"{type(self).__name__}()"


class VmapRerank(Reranker):
    """Decode every (query, candidate) pair: the (Q, L, D) oracle."""

    def distances(self, index, queries, cand):
        q, l = cand.shape
        recon = index._reconstruct(index.codes[cand.reshape(-1).long()])
        recon = recon.reshape(q, l, -1)
        return torch.sum(torch.square(recon - queries[:, None, :]), dim=-1)


class TableRerank(Reranker):
    """Stage 2 for table-decodable quantizers: the candidates' codes are
    gathered as uint8 (L * M bytes per query, ~50x fewer than the float
    reconstruction) and ``ops.rerank_gather_dist`` does the rest."""

    def __init__(self, table: torch.Tensor):
        self.table = table              # (M, K, D) f32 decode table

    def distances(self, index, queries, cand):
        cand_codes = index.codes[cand.long()]              # (Q, L, M) u8
        return ops.rerank_gather_dist(cand_codes, queries.float(),
                                      self.table)


def _gathered_dist_chunked(recon_u: torch.Tensor, queries: torch.Tensor,
                           inv: torch.Tensor, *, chunk_l: int):
    """d[q, l] = ||queries[q] - recon_u[inv[q, l]]||^2 over (Q, chunk_l)
    column chunks: peak gathered memory O(Q * chunk_l * D)."""
    parts = []
    for s in range(0, inv.shape[1], chunk_l):
        recon = recon_u[inv[:, s:s + chunk_l]]              # (Q, c, D)
        parts.append(torch.sum(torch.square(recon - queries[:, None, :]),
                               dim=-1))
    return torch.cat(parts, dim=1)


class DedupRerank(Reranker):
    """Cross-query candidate dedup for decoder quantizers (UNQ): each
    unique candidate is decoded once; see the module docstring."""

    def distances(self, index, queries, cand):
        q, l = cand.shape
        uniq, inv = torch.unique(cand, sorted=True, return_inverse=True)
        # smallest ladder bucket >= n_unique (>= 8 keeps the decoder's
        # matmuls off degenerate single-row shapes)
        chunk = DEDUP_DECODE_CHUNK
        while chunk // 2 >= max(uniq.numel(), 8) and chunk > 8:
            chunk //= 2
        pad = (-uniq.numel()) % chunk
        rows_u = torch.cat([uniq, uniq.new_zeros(pad)]).long()
        codes_u = index.codes[rows_u]                       # (U_pad, M)
        recon_u = torch.cat([index._reconstruct(codes_u[s:s + chunk])
                             for s in range(0, codes_u.shape[0], chunk)])
        return _gathered_dist_chunked(recon_u, queries.float(),
                                      inv.reshape(q, l),
                                      chunk_l=DEDUP_DIST_CHUNK)


def reranker_for(index) -> Reranker:
    """Resolve an index to its stage-2 reranker: ``TableRerank`` for a
    table-decodable index (PQ / OPQ) and ``DedupRerank`` for a decoder
    quantizer (UNQ), on both backends. Like the reference, which gives
    its streaming backends without ``fused_rerank`` the chunked table
    path, the table path is kept on the CPU: ``ops.rerank_gather_dist``
    runs its plain version there and the fused kernel on the card."""
    table = index._decode_table()
    return DedupRerank() if table is None else TableRerank(table)
