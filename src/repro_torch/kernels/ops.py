"""Public entry points of the kernels package.

Dispatch goes by the tensors' device, with no fallback: a CPU tensor
takes the plain PyTorch version, a CUDA tensor takes the hand-written
kernel, and if the kernel cannot run (no ``nvcc``, another GPU, a shape
it does not take) the call raises. The wrappers pad the small inputs to
the kernels' tile multiples (the LUTs to ``BLOCK_Q`` queries, the heads
to ``BLOCK_B`` rows); the N-long streams are never padded, since the
scan kernel masks the ragged edge of N itself, and neither is stage 2's
(Q, L) candidate grid, whose edges the rerank kernel masks.

The reference's reduced-precision stage 1 (``lut_dtype``/``overfetch``)
is not ported yet and raises instead of silently scanning in f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rerank_dist, topl_scan
from repro_torch.kernels import unq_encode as _unq_encode


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def adc_scan_topl(codes: torch.Tensor, luts: torch.Tensor, *, topl: int,
                  bias: torch.Tensor | None = None,
                  qbias: torch.Tensor | None = None,
                  lut_dtype: str = "float32", overfetch: int = 1):
    """Streaming stage 1: codes (N, M) uint8, luts (Q, M, K), optional
    bias (N,) and qbias (Q, N) -> ((Q, L) f32, (Q, L) int32) with
    L = min(topl, N), sorted by (score asc, index asc) and bit-identical
    to ``ref.adc_scan_topl_ref``. ``qbias`` is the lowered per-query
    filter (+inf drops a point for one query)."""
    if lut_dtype != "float32" or overfetch != 1:
        raise NotImplementedError(
            f"lut_dtype={lut_dtype!r} / overfetch={overfetch}: the "
            "quantized-LUT stage 1 is not ported yet (ROADMAP A6)")
    n = codes.shape[0]
    q = luts.shape[0]
    topl = min(topl, n)
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.float32, device=codes.device)
    luts = luts.float()
    if codes.is_cuda:
        return topl_scan.adc_scan_topl_cuda(
            codes.contiguous(), _pad_rows(luts.contiguous(),
                                          topl_scan.BLOCK_Q),
            bias.float().contiguous(),
            None if qbias is None else qbias.float().contiguous(),
            topl=topl, num_queries=q)
    chunk_n = min(topl_scan.DEFAULT_CHUNK_N, max(topl, -(-n // 8)))
    return topl_scan.adc_scan_topl_stream(
        codes, luts, bias.float(),
        None if qbias is None else qbias.float(),
        topl=topl, n_valid=n, chunk_n=chunk_n)


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
