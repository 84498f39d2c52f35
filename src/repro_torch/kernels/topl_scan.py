"""Streaming scan + top-L (stage 1): plain version + CUDA kernel.

Per query, the L smallest ``chain_m lut[q, m, code[n, m]] + bias[n]
(+ qbias[q, n])`` with their row ids, sorted by (score asc, id asc) and
bit-identical to ``ref.adc_scan_topl_ref``, without a (Q, N) buffer.

  * ``adc_scan_topl_stream``: PyTorch, the chunked stream of
    ``repro/kernels/topl_scan.py::adc_scan_topl_stream_xla``: a (Q, L)
    carry, each chunk scored with the ``ref`` chain, rows at or past
    ``n_valid`` set to +inf, folded in with the exact lexicographic
    merge. The CPU path of ``ops.adc_scan_topl``.
  * ``adc_scan_topl_cuda``: the hand-written kernel ``csrc/topl_scan.cu``
    (replaces ``repro/kernels/topl_scan.py::adc_scan_topl_pallas``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, merge, ref

DEFAULT_CHUNK_N = 4096
#: queries per CUDA block; ``ops.adc_scan_topl`` pads the LUTs to a multiple
BLOCK_Q = 8
#: the kernel's heaps hold at most this many pairs per query
MAX_TOPL = 1024
#: rows per slice below which the kernel stops splitting N further
MIN_SLICE_ROWS = 8192
#: dynamic shared memory a block may use on Hopper
MAX_SMEM_BYTES = 232_448

_IMAX = torch.iinfo(torch.int32).max


def adc_scan_topl_stream(codes: torch.Tensor, luts: torch.Tensor,
                         bias: torch.Tensor,
                         qbias: torch.Tensor | None = None, *, topl: int,
                         n_valid: int, chunk_n: int = DEFAULT_CHUNK_N):
    """codes (N, M), luts (Q, M, K) f32, bias (N,), qbias None | (Q, N)
    -> ((Q, topl) f32, (Q, topl) int32), topl <= n_valid <= N."""
    n = codes.shape[0]
    q = luts.shape[0]
    dev = luts.device
    vals = torch.full((q, topl), float("inf"), device=dev)
    idx = torch.full((q, topl), _IMAX, dtype=torch.int32, device=dev)
    for start in range(0, n, chunk_n):
        stop = min(start + chunk_n, n)
        s = ref.adc_scan_batch_ref(codes[start:stop], luts) \
            + bias[start:stop][None, :]
        if qbias is not None:
            s = s + qbias[:, start:stop]
        gids = torch.arange(start, stop, dtype=torch.int32, device=dev)
        s = torch.where(gids[None, :] < n_valid, s, float("inf"))
        vals, idx = merge.merge_topl_pairs(
            vals, idx, s, gids[None, :].expand(q, -1), topl)
    return vals, idx


@functools.cache
def _launcher():
    lib = build.library("topl_scan")
    fn = lib.adc_scan_topl_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.adc_scan_topl_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_size_t
    return lib, fn, smem


def num_slices(n: int, q_tiles: int, device: torch.device) -> int:
    """How many slices of N the scan splits into: enough blocks for about
    four per SM, with no slice under ``MIN_SLICE_ROWS`` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = math.ceil(4 * sms / q_tiles)
    return max(1, min(want, math.ceil(n / MIN_SLICE_ROWS)))


def adc_scan_topl_cuda(codes: torch.Tensor, luts: torch.Tensor,
                       bias: torch.Tensor,
                       qbias: torch.Tensor | None = None, *, topl: int,
                       num_queries: int, slices: int | None = None):
    """The CUDA kernel. codes (N, M) uint8, luts (Qpad, M, K) f32 with
    Qpad % BLOCK_Q == 0 (the first ``num_queries`` rows are real), bias
    (N,) f32, qbias None | (num_queries, N) f32, all contiguous on one
    card; 1 <= topl <= min(N, MAX_TOPL), K <= 256. Returns
    ((num_queries, topl) f32, (num_queries, topl) int32). The ragged N
    edge is masked in the kernel, so no N-long input is padded or
    copied. Launches on the current stream; does not synchronize."""
    device = codes.device
    if codes.ndim != 2 or luts.ndim != 3:
        raise ValueError("codes must be (N, M) and luts (Q, M, K)")
    n, m = codes.shape
    qpad, _, k = luts.shape
    q = num_queries
    build.check_cuda_tensor(codes, "codes", torch.uint8, (n, m), device)
    build.check_cuda_tensor(luts, "luts", torch.float32, (qpad, m, k), device)
    build.check_cuda_tensor(bias, "bias", torch.float32, (n,), device)
    if qbias is not None:
        build.check_cuda_tensor(qbias, "qbias", torch.float32, (q, n), device)
    if qpad % BLOCK_Q or not 0 < q <= qpad:
        raise ValueError(f"luts must hold Qpad={qpad} (a multiple of "
                         f"{BLOCK_Q}) >= num_queries={q} > 0 tables")
    if not 0 < topl <= min(n, MAX_TOPL) or k > 256:
        raise ValueError(f"need 1 <= topl={topl} <= min(N={n}, {MAX_TOPL}) "
                         f"and K={k} <= 256")
    build.check_sm90(device)
    lib, fn, smem_bytes = _launcher()
    lp = max(32, 1 << (topl - 1).bit_length())
    if smem_bytes(m, k, lp) > MAX_SMEM_BYTES:
        raise ValueError(f"M={m}, K={k}, L={topl} need "
                         f"{smem_bytes(m, k, lp)} B of shared memory per "
                         f"block, above {MAX_SMEM_BYTES}")
    s = slices if slices is not None else num_slices(n, qpad // BLOCK_Q,
                                                     device)
    part_s = torch.empty((qpad, s, topl), dtype=torch.float32, device=device)
    part_g = torch.empty((qpad, s, topl), dtype=torch.int32, device=device)
    out_s = torch.empty((q, topl), dtype=torch.float32, device=device)
    out_g = torch.empty((q, topl), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = fn(codes.data_ptr(), luts.data_ptr(), bias.data_ptr(),
                 None if qbias is None else qbias.data_ptr(), n,
                 part_s.data_ptr(), part_g.data_ptr(), out_s.data_ptr(),
                 out_g.data_ptr(), n, q, qpad, m, k, topl, lp, s,
                 torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, "adc_scan_topl", err)
    adc_scan_topl_cuda.launches += 2    # topl_scan_kernel, topl_merge_kernel
    return out_s, out_g


adc_scan_topl_cuda.launches = 0
