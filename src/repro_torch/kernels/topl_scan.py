"""Streaming scan + top-L (stage 1): plain version + CUDA kernel.

Per query, the L smallest ``chain_m part(q, m, code[n, m]) + bias[n]
(+ qbias[q, n])`` with their row ids, sorted by (score asc, id asc) and
bit-identical to ``ref.adc_scan_topl_ref`` (f32 tables) or
``ref.adc_scan_topl_q_ref`` (f16 tables, or i8 tables with a (Q, M)
scale), without a (Q, N) buffer. ``part`` is the table entry as f32,
times ``scale[q, m]`` for i8 tables.

  * ``adc_scan_topl_stream``: PyTorch, the chunked stream of
    ``repro/kernels/topl_scan.py::adc_scan_topl_stream_xla``: quantized
    tables dequantized once up front, then a (Q, L) carry, each chunk
    scored with the ``ref`` chain, rows at or past ``n_valid`` set to
    +inf, folded in with the exact lexicographic merge. The CPU path of
    ``ops.adc_scan_topl``.
  * ``adc_scan_topl_cuda``: the hand-written kernel ``csrc/topl_scan.cu``
    (replaces ``repro/kernels/topl_scan.py::adc_scan_topl_pallas``, all
    three table types). ``block_q`` picks its queries per block from the
    shared memory a shape needs; a shape that fits at no block size
    raises before anything is allocated or launched.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, merge, ref

DEFAULT_CHUNK_N = 4096
#: rows per slice below which the kernel stops splitting N further
MIN_SLICE_ROWS = 8192
#: bytes per table entry of each LUT type the kernel takes
LUT_BYTES = {"float32": 4, "float16": 2, "int8": 1}
#: the ``lut_dtype`` name of each table tensor type
LUT_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                   torch.int8: "int8"}

_IMAX = torch.iinfo(torch.int32).max


def heap_width(topl: int) -> int:
    """LP, the kernel's per-query heap: the next power of two >= topl,
    at least one warp wide."""
    return max(32, 1 << (topl - 1).bit_length())


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(bq: int, m: int, k: int, topl: int,
               lut_dtype: str = "float32") -> int:
    """Shared memory of one scan block of ``bq`` queries (mirrors
    ``scan_smem_bytes`` in ``csrc/topl_scan.cu``): the tables (and the
    i8 scales), each region 16-byte aligned, then per query a heap of
    ``heap_width(topl)`` and a candidate buffer of 64 * bq (score, id)
    pairs, and a count."""
    lut = LUT_BYTES[lut_dtype]
    scales = _align16(4 * bq * m) if lut == 1 else 0
    return (_align16(lut * bq * m * k) + scales
            + 8 * bq * (heap_width(topl) + 64 * bq) + 4 * bq)


def block_q(m: int, k: int, topl: int, lut_dtype: str = "float32") -> int:
    """Queries per block for the scan kernel: the largest of
    ``build.BLOCK_QS`` whose shared memory fits in
    ``build.MAX_SMEM_BYTES``. Raises ValueError, naming the bytes needed,
    when even one query per block does not fit."""
    return build.largest_block_q(
        lambda bq: smem_bytes(bq, m, k, topl, lut_dtype),
        f"stage 1 at M={m}, K={k}, L={topl} with {lut_dtype} tables")


def adc_scan_topl_stream(codes: torch.Tensor, luts: torch.Tensor,
                         bias: torch.Tensor,
                         qbias: torch.Tensor | None = None,
                         scale: torch.Tensor | None = None, *, topl: int,
                         n_valid: int, chunk_n: int = DEFAULT_CHUNK_N):
    """codes (N, M), luts (Q, M, K) f32 / f16 / i8 (with scale (Q, M)
    f32), bias (N,), qbias None | (Q, N) -> ((Q, topl) f32, (Q, topl)
    int32), topl <= n_valid <= N. Quantized tables are dequantized once:
    ``f32(lut)[code] == f32(lut[code])`` and scaling the table entry is
    the same IEEE multiply as scaling the gathered part, so the scores
    are ``ref.adc_scan_batch_q_ref``'s bit for bit."""
    if luts.dtype != torch.float32:
        luts = luts.float()
        if scale is not None:
            luts = luts * scale[:, :, None]
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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.adc_scan_topl_smem_bytes
    smem.argtypes = [ctypes.c_int] * 5
    smem.restype = ctypes.c_size_t
    return lib, fn, smem


def kernel_smem_bytes(bq: int, m: int, k: int, topl: int,
                      lut_dtype: str = "float32") -> int:
    """What the built kernel allocates for one block (``smem_bytes`` must
    agree with it; the card tests check that)."""
    return int(_launcher()[2](bq, m, k, heap_width(topl),
                              LUT_BYTES[lut_dtype]))


def num_slices(n: int, q_tiles: int, device: torch.device) -> int:
    """How many slices of N the scan splits into: enough blocks for about
    four per SM, with no slice under ``MIN_SLICE_ROWS`` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = math.ceil(4 * sms / q_tiles)
    return max(1, min(want, math.ceil(n / MIN_SLICE_ROWS)))


def adc_scan_topl_cuda(codes: torch.Tensor, luts: torch.Tensor,
                       bias: torch.Tensor,
                       qbias: torch.Tensor | None = None,
                       scale: torch.Tensor | None = None, *, topl: int,
                       num_queries: int, slices: int | None = None):
    """The CUDA kernel. codes (N, M) uint8, luts (Qpad, M, K) float32,
    float16 or int8 with Qpad a multiple of ``block_q(M, K, topl, type)``
    (the first ``num_queries`` rows are real), scale (Qpad, M) f32 for
    int8 tables and None otherwise, bias (N,) f32, qbias None |
    (num_queries, N) f32, all contiguous on one card; 1 <= topl <= N,
    K <= 256. Returns ((num_queries, topl) f32, (num_queries, topl)
    int32). The ragged N edge is masked in the kernel, so no N-long
    input is padded or copied. Launches on the current stream; does not
    synchronize."""
    device = codes.device
    if codes.ndim != 2 or luts.ndim != 3:
        raise ValueError("codes must be (N, M) and luts (Q, M, K)")
    n, m = codes.shape
    qpad, _, k = luts.shape
    q = num_queries
    if luts.dtype not in LUT_DTYPE_NAMES:
        raise ValueError(f"luts must be float32, float16 or int8, got "
                         f"{luts.dtype}")
    lut_dtype = LUT_DTYPE_NAMES[luts.dtype]
    build.check_cuda_tensor(codes, "codes", torch.uint8, (n, m), device)
    build.check_cuda_tensor(luts, "luts", luts.dtype, (qpad, m, k), device)
    build.check_cuda_tensor(bias, "bias", torch.float32, (n,), device)
    if qbias is not None:
        build.check_cuda_tensor(qbias, "qbias", torch.float32, (q, n), device)
    if (scale is None) != (lut_dtype != "int8"):
        raise ValueError("int8 luts take a (Qpad, M) float32 scale; float32 "
                         "and float16 luts take none")
    if scale is not None:
        build.check_cuda_tensor(scale, "scale", torch.float32, (qpad, m),
                                device)
    if not 0 < topl <= n or k > 256:
        raise ValueError(f"need 1 <= topl={topl} <= N={n} and K={k} <= 256")
    bq = block_q(m, k, topl, lut_dtype)
    if qpad % bq or not 0 < q <= qpad:
        raise ValueError(f"luts must hold Qpad={qpad} (a multiple of "
                         f"{bq}) >= num_queries={q} > 0 tables")
    build.check_sm90(device)
    lib, fn, _ = _launcher()
    s = slices if slices is not None else num_slices(n, qpad // bq, device)
    part_s = torch.empty((qpad, s, topl), dtype=torch.float32, device=device)
    part_g = torch.empty((qpad, s, topl), dtype=torch.int32, device=device)
    out_s = torch.empty((q, topl), dtype=torch.float32, device=device)
    out_g = torch.empty((q, topl), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = fn(codes.data_ptr(), luts.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 LUT_BYTES[lut_dtype], bq, bias.data_ptr(),
                 None if qbias is None else qbias.data_ptr(), n,
                 part_s.data_ptr(), part_g.data_ptr(), out_s.data_ptr(),
                 out_g.data_ptr(), n, q, qpad, m, k, topl, heap_width(topl),
                 s, torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, "adc_scan_topl", err)
    adc_scan_topl_cuda.launches += 2    # topl_scan_kernel, topl_merge_kernel
    return out_s, out_g


adc_scan_topl_cuda.launches = 0
