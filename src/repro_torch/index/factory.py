"""FAISS-style string factory (the port of ``repro/index/factory.py``).

    index = index_factory("UNQ8x256,Rerank500", dim=96)   # on "cuda"
    index = index_factory("OPQ8x256,Rerank500", dim=96)

The port's grammar so far covers the flat indexes:

  UNQ{M}[x{K}]   neural quantizer (the paper); M codebooks, K codewords
                 (default 256)
  PQ{M}[x{K}]    product quantization
  OPQ{M}[x{K}]   optimized PQ: learned rotation + PQ
  Rerank{L}      stage-2 exact-reconstruction budget (d1); UNQ keeps its
                 paper default L=500 without it, PQ and OPQ are ADC-only
                 (L=0) without it
  Scan(onehot)   pin the materialized stage 1 (the full (Q, N) score
                 matrix from ``adc_scan_batch``); ``Scan(auto)`` keeps
                 the device's default backend

Every other component of the reference's grammar raises, naming the
ROADMAP slice that brings it.
"""
from __future__ import annotations

import re

from repro_torch.index.base import Index
from repro_torch.index.pq_index import OPQIndex, PQIndex
from repro_torch.index.unq_index import UNQIndex

_QUANT_RE = re.compile(r"^(UNQ|PQ|OPQ)(\d+)(?:x(\d+))?$")
_RERANK_RE = re.compile(r"^Rerank(\d+)$")
_SCAN_RE = re.compile(r"^Scan\((onehot|auto)\)$")

#: reference components not ported yet -> (pattern, the slice bringing it)
_NOT_PORTED = (
    (re.compile(r"^RVQ\d+(?:x\d+)?$"), "RVQ (ROADMAP A5b)"),
    (re.compile(r"^(IVF\d+|NProbe\d+|Residual)$"), "IVF (ROADMAP A7)"),
    (re.compile(r"^Scan\((?!onehot\)|auto\))\w+\)$"),
     "pinning a scan backend other than onehot by name (the port's "
     "streaming backend follows device=; the tuner's backends come with "
     "ROADMAP A10)"),
)


def index_factory(spec: str, dim: int, *, device="cuda") -> Index:
    """Build an untrained Index on ``device`` from a factory string."""
    quant = None
    rerank = None
    scan = "auto"
    for comp in spec.split(","):
        comp = comp.strip()
        if not comp:
            continue
        for pattern, slice_name in _NOT_PORTED:
            if pattern.match(comp):
                raise NotImplementedError(
                    f"component {comp!r} of {spec!r} is not ported yet: "
                    f"{slice_name}")
        m = _QUANT_RE.match(comp)
        if m:
            if quant is not None:
                raise ValueError(f"multiple quantizers in {spec!r}")
            quant = (m.group(1), int(m.group(2)), int(m.group(3) or 256))
            continue
        m = _RERANK_RE.match(comp)
        if m:
            rerank = int(m.group(1))
            continue
        m = _SCAN_RE.match(comp)
        if m:
            scan = m.group(1)
            continue
        raise ValueError(f"cannot parse component {comp!r} of factory string "
                         f"{spec!r} (expected UNQ8x256 / PQ8 / OPQ8x256 / "
                         "Rerank500 / Scan(onehot))")
    if quant is None:
        raise ValueError(f"no quantizer component in factory string {spec!r}")
    kw = {"backend": scan, "device": device}
    if rerank is not None:
        kw["rerank"] = rerank
    kind, books, size = quant
    if kind == "UNQ":
        return UNQIndex(dim, num_codebooks=books, codebook_size=size, **kw)
    cls = PQIndex if kind == "PQ" else OPQIndex
    return cls(dim, num_books=books, book_size=size, **kw)
