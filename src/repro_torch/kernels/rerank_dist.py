"""Fused stage 2 of the table quantizers: plain version + CUDA kernel.

``d1[q, l] = ||queries[q] - sum_m table[m, cand_codes[q, l, m]]||^2``
over each query's stage-1 candidates, without a (Q, L, D) reconstruction.
The decode is ``ref.decode_with_table``'s left-to-right chain over m.

  * ``rerank_gather_dist_chunked``: PyTorch, the counterpart of
    ``repro/kernels/rerank_dist.py::rerank_gather_dist_chunked_xla``:
    (Q, chunk_l) column chunks, each decoded and reduced before the
    next, so the held reconstruction is O(Q * chunk_l * D). The CPU path
    of ``ops.rerank_gather_dist``.
  * ``rerank_gather_dist_cuda``: the hand-written kernel
    ``csrc/rerank_dist.cu`` (replaces
    ``repro/kernels/rerank_dist.py::rerank_gather_dist_pallas``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

#: L-chunk of the plain version (the reference's DEFAULT_RERANK_CHUNK_L)
DEFAULT_CHUNK_L = 64
#: candidates per CUDA block (TILE_L in csrc/rerank_dist.cu)
TILE_L = 64
#: the kernel stages one query in at most the default 48 KB of shared
#: memory; blocks over L form grid.y, at most 65535 of them
MAX_DIM = 12_288
MAX_L = 65_535 * TILE_L


def rerank_gather_dist_chunked(cand_codes: torch.Tensor,
                               queries: torch.Tensor, table: torch.Tensor,
                               *, chunk_l: int = DEFAULT_CHUNK_L
                               ) -> torch.Tensor:
    """cand_codes (Q, L, M) integer, queries (Q, D) f32, table (M, K, D)
    f32 -> d1 (Q, L) f32, each element as ``ref.rerank_gather_dist_ref``
    computes it (the chunks split no reduction)."""
    q, l, _ = cand_codes.shape
    parts = [queries.new_zeros((q, 0))]
    for s in range(0, l, chunk_l):
        recon = ref.decode_with_table(cand_codes[:, s:s + chunk_l], table)
        parts.append(torch.sum(torch.square(recon - queries[:, None, :]),
                               dim=-1))
    return torch.cat(parts, dim=1)


@functools.cache
def _launcher():
    lib = build.library("rerank_dist")
    fn = lib.rerank_gather_dist_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def rerank_gather_dist_cuda(cand_codes: torch.Tensor, queries: torch.Tensor,
                            table: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel. cand_codes (Q, L, M) uint8, queries (Q, D) f32,
    table (M, K, D) f32, all contiguous on one card, with Q >= 1,
    1 <= L <= MAX_L and D <= MAX_DIM -> d1 (Q, L) f32. Every code must be
    below K: a candidate with a code >= K gets NaN, and the table is
    never read out of bounds. Launches on the current stream; does not
    synchronize."""
    device = cand_codes.device
    if cand_codes.ndim != 3 or queries.ndim != 2 or table.ndim != 3:
        raise ValueError("cand_codes must be (Q, L, M), queries (Q, D) and "
                         "table (M, K, D)")
    q, l, m = cand_codes.shape
    k, d = table.shape[1:]
    build.check_cuda_tensor(cand_codes, "cand_codes", torch.uint8,
                            (q, l, m), device)
    build.check_cuda_tensor(queries, "queries", torch.float32, (q, d),
                            device)
    build.check_cuda_tensor(table, "table", torch.float32, (m, k, d), device)
    if q < 1 or not 1 <= l <= MAX_L or not 1 <= d <= MAX_DIM or k < 1:
        raise ValueError(f"need Q={q} >= 1, 1 <= L={l} <= {MAX_L}, "
                         f"1 <= D={d} <= {MAX_DIM} and K={k} >= 1")
    build.check_sm90(device)
    lib, fn = _launcher()
    out = torch.empty((q, l), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = fn(cand_codes.data_ptr(), queries.data_ptr(), table.data_ptr(),
                 out.data_ptr(), q, l, m, k, d,
                 torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, "rerank_gather_dist", err)
    rerank_gather_dist_cuda.launches += 1
    return out


rerank_gather_dist_cuda.launches = 0
