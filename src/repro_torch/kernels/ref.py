"""Torch oracles for the port's kernels.

The port's counterparts of ``repro/kernels/ref.py``: the ground truth the
CUDA kernels and the plain streaming versions are held to. Sums over the
M codebooks are an explicit left-to-right chain, as in the reference, so
comparisons are bit-exact rather than association-dependent.

Tie order is ``lax.top_k``'s: among equal scores the lower index wins.
``torch.topk`` promises no tie order, so the oracles take a stable sort.
"""
from __future__ import annotations

import torch


def adc_scan_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (N, M) integer, lut (M, K) -> scores (N,) with
    ``scores[n] = lut[0, codes[n, 0]] + lut[1, codes[n, 1]] + ...``,
    accumulated left to right over m."""
    m_idx = torch.arange(lut.shape[0], device=lut.device)[None, :]
    gathered = lut[m_idx, codes.long()]                  # (N, M)
    acc = gathered[:, 0]
    for m in range(1, lut.shape[0]):
        acc = acc + gathered[:, m]
    return acc


def adc_scan_batch_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Multi-query scan: codes (N, M), luts (Q, M, K) -> (Q, N); each row
    bit-identical to ``adc_scan_ref`` with that query's table (the same
    per-element chain, with no (Q, N, M) intermediate)."""
    c = codes.long()
    acc = luts[:, 0, :].index_select(1, c[:, 0])
    for m in range(1, luts.shape[1]):
        acc = acc + luts[:, m, :].index_select(1, c[:, m])
    return acc


def adc_scan_topl_ref(codes: torch.Tensor, luts: torch.Tensor,
                      bias: torch.Tensor | None, topl: int,
                      qbias: torch.Tensor | None = None):
    """Materialized oracle for the streaming scan + top-L: the full (Q, N)
    score matrix (``+ bias`` then ``+ qbias``), then a stable ascending
    sort. Returns ((Q, L) f32, (Q, L) int32), L = min(topl, N), sorted by
    (score asc, index asc)."""
    scores = adc_scan_batch_ref(codes, luts)
    if bias is not None:
        scores = scores + bias[None, :]
    if qbias is not None:
        scores = scores + qbias
    keep = min(topl, codes.shape[0])
    s, idx = torch.sort(scores, dim=1, stable=True)
    return s[:, :keep], idx[:, :keep].to(torch.int32)


def adc_scan_batch_q_ref(codes: torch.Tensor, qluts: torch.Tensor,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """Quantized-LUT multi-query scan: codes (N, M), qluts (Q, M, K) f16
    (scale None) or i8 with scale (Q, M) f32 -> (Q, N) f32 with
    ``scores[q, n] = part_0 + part_1 + ...`` left to right, each part
    ``f32(qlut[q, m, code])`` (times ``scale[q, m]`` for i8), converted
    and scaled before it joins the chain, as the kernels do."""
    c = codes.long()
    acc = None
    for m in range(qluts.shape[1]):
        part = qluts[:, m, :].index_select(1, c[:, m]).float()
        if scale is not None:
            part = part * scale[:, m:m + 1]
        acc = part if acc is None else acc + part
    return acc


def adc_scan_topl_q_ref(codes: torch.Tensor, qluts: torch.Tensor,
                        scale: torch.Tensor | None,
                        bias: torch.Tensor | None, topl: int,
                        qbias: torch.Tensor | None = None):
    """Materialized oracle of the quantized pool scan: the (Q, N) matrix
    of ``adc_scan_batch_q_ref``, the same f32 ``+ bias`` and ``+ qbias``
    as the exact path, then a stable ascending sort. Returns ((Q, L) f32,
    (Q, L) int32), L = min(topl, N)."""
    scores = adc_scan_batch_q_ref(codes, qluts, scale)
    if bias is not None:
        scores = scores + bias[None, :]
    if qbias is not None:
        scores = scores + qbias
    keep = min(topl, codes.shape[0])
    s, idx = torch.sort(scores, dim=1, stable=True)
    return s[:, :keep], idx[:, :keep].to(torch.int32)


def unq_encode_ref(heads: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Codeword assignment (paper Eq. 4): heads (B, M, d_c), codebooks
    (M, K, d_c) -> codes (B, M) int32, argmax_k <heads[b, m], c[m, k]>
    with the first maximum winning."""
    scores = torch.einsum("bmd,mkd->bmk", heads, codebooks)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def decode_with_table(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Additive table decode: codes (..., M) integer, table (M, K, D) ->
    (..., D) with ``recon = table[0, codes[..., 0]] + table[1, ...] + ...``,
    accumulated left to right over m. This is the reconstruction stage 2
    of the table quantizers is defined over (PQ embeds each sub-codebook
    in its D-slice; OPQ also folds in the rotation)."""
    c = codes.long()
    acc = table[0][c[..., 0]]
    for m in range(1, table.shape[0]):
        acc = acc + table[m][c[..., m]]
    return acc


def rerank_gather_dist_ref(cand_codes: torch.Tensor, queries: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """Materialized oracle of stage 2 over a decode table: cand_codes
    (Q, L, M), queries (Q, D), table (M, K, D) -> d1 (Q, L) with
    ``d1[q, l] = ||queries[q] - decode_with_table(cand_codes[q, l])||^2``.
    Builds the whole (Q, L, D) reconstruction on purpose."""
    recon = decode_with_table(cand_codes, table)
    return torch.sum(torch.square(recon - queries[:, None, :]), dim=-1)
