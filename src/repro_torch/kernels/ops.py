"""Public entry points of the kernels package.

Dispatch goes by the tensors' device, with no fallback: a CPU tensor
takes the plain PyTorch version, a CUDA tensor takes the hand-written
kernel, and if the kernel cannot run (no ``nvcc``, another GPU, a shape
it does not take) the call raises. The wrappers pad the small inputs to
the kernels' tile multiples (the LUTs and i8 scales to the scan's
queries per block, the heads to ``BLOCK_B`` rows); the N-long streams
are never padded, since the scan kernels mask the ragged edge of N
themselves, and neither is stage 2's (Q, L) candidate grid, whose edges
the rerank kernel masks.

``adc_scan_topl`` takes ``lut_dtype`` / ``overfetch`` for the
reduced-precision stage 1 (``lut_quant``): the scan runs on f16 or i8
tables and selects a pool of ``overfetch * topl`` candidates, the pool
is re-scored with the exact f32 chain (plain torch ops on either device,
as the reference leaves it to XLA outside its kernels), and the exact
lexicographic top-L of the pool is returned. The default,
``lut_dtype='float32', overfetch=1``, is the bit-exact path unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (adc_scan as _adc_scan, lut_quant, ref,
                                 rerank_dist, topl_scan)
from repro_torch.kernels import unq_encode as _unq_encode


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def adc_scan(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """scores[n] = sum_m lut[m, codes[n, m]], left to right over m:
    codes (N, M) uint8, lut (M, K) -> (N,) f32."""
    lut = lut.float()
    if codes.is_cuda:
        return _adc_scan.adc_scan_cuda(codes.contiguous(), lut.contiguous())
    return ref.adc_scan_ref(codes, lut)


def adc_scan_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Multi-query scan: codes (N, M) uint8, luts (Q, M, K) -> (Q, N) f32,
    each row bit-identical to ``adc_scan`` with that query's table."""
    luts = luts.float()
    if codes.is_cuda:
        return _adc_scan.adc_scan_batch_cuda(codes.contiguous(),
                                             luts.contiguous())
    return ref.adc_scan_batch_ref(codes, luts)


def _scan_topl_run(codes, luts, scale, bias, qbias, *, topl: int):
    """One streaming scan + top-L pass at the tables' precision (the
    engine behind the exact path and the quantized pool scan)."""
    n = codes.shape[0]
    q = luts.shape[0]
    if codes.is_cuda:
        m, k = luts.shape[1:]
        bq = topl_scan.block_q(m, k, topl,
                               topl_scan.LUT_DTYPE_NAMES[luts.dtype])
        return topl_scan.adc_scan_topl_cuda(
            codes.contiguous(), _pad_rows(luts.contiguous(), bq),
            bias.contiguous(),
            None if qbias is None else qbias.contiguous(),
            None if scale is None else _pad_rows(scale.contiguous(), bq),
            topl=topl, num_queries=q)
    chunk_n = min(topl_scan.DEFAULT_CHUNK_N, max(topl, -(-n // 8)))
    return topl_scan.adc_scan_topl_stream(
        codes, luts, bias, qbias, scale, topl=topl, n_valid=n,
        chunk_n=chunk_n)


def _rescore_flat(codes, luts, bias, qbias, pool_g, topl: int):
    """Exact f32 re-score of a flat-scan candidate pool: the exact path's
    score composition (left-to-right chain, ``+ bias``, ``+ qbias``) at
    the pool's rows, then the exact lexicographic top-L. Rows at or past
    N (a heap pad) score +inf."""
    n, num_books = codes.shape
    rows = pool_g.clamp(max=n - 1).long()                   # (Q, P)
    c = codes[rows].long()                                  # (Q, P, M)
    s = torch.gather(luts[:, 0, :], 1, c[..., 0])
    for m in range(1, num_books):
        s = s + torch.gather(luts[:, m, :], 1, c[..., m])
    s = s + bias[rows]
    if qbias is not None:
        s = s + torch.gather(qbias, 1, rows)
    s = torch.where(pool_g >= n, float("inf"), s)
    return lut_quant.exact_topl(s, pool_g, topl)


def adc_scan_topl(codes: torch.Tensor, luts: torch.Tensor, *, topl: int,
                  bias: torch.Tensor | None = None,
                  qbias: torch.Tensor | None = None,
                  lut_dtype: str = "float32", overfetch: int = 1):
    """Streaming stage 1: codes (N, M) uint8, luts (Q, M, K), optional
    bias (N,) and qbias (Q, N) -> ((Q, L) f32, (Q, L) int32) with
    L = min(topl, N), sorted by (score asc, index asc) and bit-identical
    to ``ref.adc_scan_topl_ref``. ``qbias`` is the lowered per-query
    filter (+inf drops a point for one query).

    ``lut_dtype`` in {'float16', 'int8'} (or ``overfetch`` > 1) selects a
    pool of ``lut_quant.pool_width(L, overfetch, N)`` candidates under
    quantized tables (``ref.adc_scan_topl_q_ref``'s pool), re-scores it
    exactly and returns its exact top-L."""
    lut_quant.check_lut_dtype(lut_dtype)
    n = codes.shape[0]
    topl = min(topl, n)
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.float32, device=codes.device)
    bias = bias.float()
    qbias = None if qbias is None else qbias.float()
    luts = luts.float()
    if lut_dtype == "float32" and overfetch == 1:
        return _scan_topl_run(codes, luts, None, bias, qbias, topl=topl)
    pool_l = lut_quant.pool_width(topl, overfetch, n)
    qluts, scale = lut_quant.quantize_luts(luts, lut_dtype)
    _, pool_g = _scan_topl_run(codes, qluts, scale, bias, qbias,
                               topl=pool_l)
    return _rescore_flat(codes, luts, bias, qbias, pool_g, topl)


def unq_encode(heads: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes[b, m] = argmax_k <heads[b, m], codebooks[m, k]> (first max
    wins): heads (B, M, d_c), codebooks (M, K, d_c) -> (B, M) int32."""
    if heads.is_cuda:
        b = heads.shape[0]
        if b == 0:
            return torch.empty((0, heads.shape[1]), dtype=torch.int32,
                               device=heads.device)
        padded = _pad_rows(heads.float().contiguous(), _unq_encode.BLOCK_B)
        return _unq_encode.unq_encode_cuda(
            padded, codebooks.float().contiguous())[:b]
    return _unq_encode.unq_encode_plain(heads, codebooks)


def rerank_gather_dist(cand_codes: torch.Tensor, queries: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Stage 2 of the table quantizers: cand_codes (Q, L, M) uint8,
    queries (Q, D), table (M, K, D) -> d1 (Q, L) f32 with ``d1[q, l] =
    ||queries[q] - ref.decode_with_table(cand_codes[q, l], table)||^2``,
    without a (Q, L, D) reconstruction."""
    queries = queries.float()
    table = table.float()
    if cand_codes.is_cuda:
        return rerank_dist.rerank_gather_dist_cuda(
            cand_codes.contiguous(), queries.contiguous(), table.contiguous())
    return rerank_dist.rerank_gather_dist_chunked(cand_codes, queries, table)
