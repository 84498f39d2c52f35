"""Fused UNQ codeword assignment (paper Eq. 4): plain version + CUDA kernel.

``codes[b, m] = argmax_k <heads[b, m], codebooks[m, k]>``, first maximum
winning, without storing the (B, M, K) scores.

  * ``unq_encode_plain``: PyTorch, streaming K in tiles with a running
    (max, argmax) replaced only on a strictly greater score, the scheme
    of the kernel. The CPU path of ``ops.unq_encode``.
  * ``unq_encode_cuda``: the hand-written kernel ``csrc/unq_encode.cu``
    (replaces ``repro/kernels/unq_encode.py::unq_encode_pallas``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: head rows per CUDA block; ``ops.unq_encode`` pads B to a multiple
BLOCK_B = 64
#: codewords per streamed tile (kernel and plain version)
TILE_K = 64


def unq_encode_plain(heads: torch.Tensor,
                     codebooks: torch.Tensor) -> torch.Tensor:
    """heads (B, M, d_c), codebooks (M, K, d_c) -> (B, M) int32."""
    b, m, _ = heads.shape
    best_v = torch.full((b, m), float("-inf"), device=heads.device)
    best_k = torch.zeros((b, m), dtype=torch.int64, device=heads.device)
    for k0 in range(0, codebooks.shape[1], TILE_K):
        s = torch.einsum("bmd,mkd->bmk", heads, codebooks[:, k0:k0 + TILE_K])
        v, k = s.max(dim=-1)                 # first max within the tile
        take = (v > best_v) | (k0 == 0)      # strictly greater across tiles
        best_v = torch.where(take, v, best_v)
        best_k = torch.where(take, k + k0, best_k)
    return best_k.to(torch.int32)


@functools.cache
def _launcher():
    lib = build.library("unq_encode")
    fn = lib.unq_encode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def unq_encode_cuda(heads: torch.Tensor,
                    codebooks: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: heads (B, M, d_c) f32 with B % BLOCK_B == 0,
    codebooks (M, K, d_c) f32, both contiguous on one card ->
    (B, M) int32. Launches on the current stream; does not synchronize."""
    device = heads.device
    if heads.ndim != 3 or codebooks.ndim != 3:
        raise ValueError("heads and codebooks must be 3-d")
    b, m, d = heads.shape
    k = codebooks.shape[1]
    build.check_cuda_tensor(heads, "heads", torch.float32, (b, m, d), device)
    build.check_cuda_tensor(codebooks, "codebooks", torch.float32,
                            (m, k, d), device)
    if b % BLOCK_B or b == 0:
        raise ValueError(f"B={b} must be a positive multiple of {BLOCK_B}")
    build.check_sm90(device)
    out = torch.empty((b, m), dtype=torch.int32, device=device)
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(heads.data_ptr(), codebooks.data_ptr(), out.data_ptr(),
                 b, m, k, d, torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, "unq_encode", err)
    unq_encode_cuda.launches += 1
    return out


unq_encode_cuda.launches = 0
