"""Reduced-precision stage-1 LUTs (the port of ``repro/kernels/lut_quant.py``).

The quantized scan is a pool selector: it over-fetches ``overfetch * L``
candidates under f16 or i8 tables, the pool is re-scored with the exact
f32 chain, and the exact lexicographic top-L of the pool is the result
(``ops.adc_scan_topl``). ``lut_dtype='float32', overfetch=1`` bypasses
all of it.

  float16  the table cast to f16 (round to nearest even); the score is
           ``chain_m f32(f16(lut))``.
  int8     per (query, book) row: ``zp = (max + min) * 0.5``, a scale,
           and ``q8 = clip(round((lut - zp) / scale), -127, 127)`` with
           half-to-even rounding; the score is ``chain_m f32(q8) *
           scale``. The per-query offset ``sum_m zp`` is dropped: it
           moves every candidate of a query alike.

The scale is meant as the smallest power of two >= ``raw = max(hi - lo,
1e-30) / 254``. The reference computes it under ``jax.jit`` as
``exp2(ceil(log2(raw)))``, which XLA compiles into ``log(raw) *
f32(1/ln 2)``, ``ceil``, and ``exp(n * f32(ln 2))``, with its own f32
``log`` on the CPU (a Cephes polynomial with fused multiply-adds) and a
division by the constant 254 turned into a product with ``f32(1/254)``.
That is not always the power of two it is meant to be: at an exact
power of two ``raw = 2^k``, ``log`` lands just above k for some k
(k = -27, -30, -31, ...) and the scale doubles; one ulp above 2^k it
rounds back down to k; and ``exp(13 * f32(ln 2))`` is 8192.0039, not
8192. ``_int8_scale`` reproduces those steps op for op, in float64 where
a fused multiply-add is emulated, on whatever device the tables are, so
scales and codes equal the reference's bit for bit on the CPU and on the
card alike. ``ops.adc_scan_topl`` and the kernel take the scale as
given; nothing downstream assumes a power of two.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import merge

#: lut_dtype values accepted by the search/ops APIs
LUT_DTYPES = ("float32", "float16", "int8")

# Cephes logf (XLA CPU's f32 log): polynomial and range-split constants
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524
_INV_LN2, _LN2 = 1.4426950408889634, 0.6931471805599453


def check_lut_dtype(lut_dtype: str) -> str:
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"unknown lut_dtype {lut_dtype!r} "
                         f"(choose from {LUT_DTYPES})")
    return lut_dtype


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding: the product of two f32
    values is exact in float64, so only the sum rounds there first."""
    return (a.double() * b + c).float()


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU, for positive normal ``x``: frexp,
    the sqrt(1/2) range split, the Cephes polynomial evaluated with
    fused multiply-adds, and the exponent folded back in two parts."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    x = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    low = x < _f32(_SQRTHF)
    x = (x - 1.0) + torch.where(low, x, torch.zeros_like(x))
    e = e - low.float()
    p = [_f32(c) for c in _LOG_P]
    x2 = x * x
    x3 = x2 * x
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(_LOG_Q1))
    x = (x - x2 * 0.5) + y
    return x + e * _f32(_LOG_Q2)


@functools.cache
def _exp_table() -> torch.Tensor:
    """``exp(f32(n * f32(ln 2)))`` rounded to f32, for n = -126 .. 128
    (index n + 126): the values XLA's ``exp`` gives there, computed once
    on the CPU in float64 so every device reads the same bits."""
    n = torch.arange(-126, 129, dtype=torch.float32)
    return torch.exp((n * _f32(_LN2)).double()).float()


def _int8_scale(raw: torch.Tensor) -> torch.Tensor:
    """The reference's ``exp2(ceil(log2(raw)))`` as XLA computes it (see
    the module docstring), for positive normal f32 ``raw``."""
    n = torch.ceil(_xla_log(raw) * _f32(_INV_LN2))
    table = _exp_table().to(raw.device)
    return table[(n.long() + 126).clamp(0, table.numel() - 1)]


def quantize_luts(luts: torch.Tensor, lut_dtype: str):
    """Quantize f32 (Q, M, K) score tables for the reduced-precision scan.

    Returns ``(qluts, scale)``: for 'float32' ``(f32 tables, None)``, for
    'float16' ``(f16 tables, None)``, for 'int8' ``(i8 tables, (Q, M) f32
    scales)``, on the tables' device.
    """
    check_lut_dtype(lut_dtype)
    luts = luts.float()
    if lut_dtype == "float32":
        return luts, None
    if lut_dtype == "float16":
        return luts.half(), None
    hi = luts.amax(dim=2)                                   # (Q, M)
    lo = luts.amin(dim=2)
    zp = (hi + lo) * 0.5
    raw = torch.clamp(hi - lo, min=_f32(1e-30)) * _f32(1.0 / 254.0)
    scale = _int8_scale(raw)
    q8 = torch.clamp(torch.round((luts - zp[..., None]) / scale[..., None]),
                     -127, 127).to(torch.int8)
    return q8, scale


def pool_width(topl: int, overfetch: int, limit: int) -> int:
    """The over-fetched pool width L' = overfetch * L, clamped to the
    scannable population."""
    if overfetch < 1:
        raise ValueError(f"overfetch must be >= 1, got {overfetch}")
    return min(limit, max(topl, int(overfetch) * topl))


def exact_topl(scores: torch.Tensor, gids: torch.Tensor, topl: int):
    """Exact lexicographic (score asc, gid asc) top-``topl`` over an
    unordered candidate pool (..., P): the final selection after the
    exact f32 re-score, with the tie rule of every exact path."""
    return merge.lex_topl(scores, gids, topl)
