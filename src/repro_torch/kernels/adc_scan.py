"""Materialized ADC scans: CUDA kernels (the port of
``repro/kernels/adc_scan.py``).

  * ``adc_scan_cuda``: codes (N, M) uint8, lut (M, K) f32 -> (N,) f32,
    ``scores[n] = lut[0, codes[n, 0]] + lut[1, codes[n, 1]] + ...``
    (replaces ``adc_scan_pallas``);
  * ``adc_scan_batch_cuda``: codes (N, M), luts (Q, M, K) f32 -> (Q, N)
    f32, each row that chain with its query's table (replaces
    ``adc_scan_batch_pallas``).

Both are ``csrc/adc_scan.cu`` and equal ``ref.adc_scan_ref`` /
``ref.adc_scan_batch_ref`` bit for bit. Those two are the plain versions
too: the output is the whole score vector or matrix, so there is no
stream to chunk, and ``ops.adc_scan`` / ``ops.adc_scan_batch`` run them
for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

def _block_q(m: int, k: int) -> int:
    """Queries per block: the most whose f32 tables (4 * bq * M * K
    bytes) fit in shared memory (``build.largest_block_q``)."""
    return build.largest_block_q(lambda bq: 4 * bq * m * k,
                                 f"an (M={m}, K={k}) f32 table")


@functools.cache
def _launchers():
    lib = build.library("adc_scan")
    one = lib.adc_scan_launch
    one.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    one.restype = ctypes.c_int
    batch = lib.adc_scan_batch_launch
    batch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    batch.restype = ctypes.c_int
    return lib, one, batch


def _check_codes(codes: torch.Tensor, m: int, device) -> int:
    if codes.ndim != 2 or codes.shape[1] != m or codes.shape[0] < 1:
        raise ValueError(f"codes must be (N >= 1, M={m}), got "
                         f"{tuple(codes.shape)}")
    n = codes.shape[0]
    build.check_cuda_tensor(codes, "codes", torch.uint8, (n, m), device)
    return n


def adc_scan_cuda(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The single-table kernel: codes (N, M) uint8 and lut (M, K) f32,
    contiguous on one card, K <= 256 -> (N,) f32. Launches on the
    current stream; does not synchronize."""
    device = lut.device
    if lut.ndim != 2:
        raise ValueError("lut must be (M, K)")
    m, k = lut.shape
    n = _check_codes(codes, m, device)
    build.check_cuda_tensor(lut, "lut", torch.float32, (m, k), device)
    if k > 256:
        raise ValueError(f"K={k} > 256 (codes are uint8)")
    _block_q(m, k)
    build.check_sm90(device)
    lib, one, _ = _launchers()
    out = torch.empty((n,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = one(codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, m, k,
                  torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, "adc_scan", err)
    adc_scan_cuda.launches += 1
    return out


def adc_scan_batch_cuda(codes: torch.Tensor,
                        luts: torch.Tensor) -> torch.Tensor:
    """The batch kernel: codes (N, M) uint8 and luts (Q, M, K) f32,
    contiguous on one card, Q >= 1, K <= 256 -> (Q, N) f32. Launches on
    the current stream; does not synchronize."""
    device = luts.device
    if luts.ndim != 3 or luts.shape[0] < 1:
        raise ValueError("luts must be (Q >= 1, M, K)")
    q, m, k = luts.shape
    n = _check_codes(codes, m, device)
    build.check_cuda_tensor(luts, "luts", torch.float32, (q, m, k), device)
    if k > 256:
        raise ValueError(f"K={k} > 256 (codes are uint8)")
    bq = _block_q(m, k)
    build.check_sm90(device)
    lib, _, batch = _launchers()
    out = torch.empty((q, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = batch(codes.data_ptr(), luts.data_ptr(), out.data_ptr(), n, q,
                    m, k, bq, torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, "adc_scan_batch", err)
    adc_scan_batch_cuda.launches += 1
    return out


adc_scan_cuda.launches = 0
adc_scan_batch_cuda.launches = 0
