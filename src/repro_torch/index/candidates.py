"""Pluggable stage-1 candidate generation (the port of
``repro/index/candidates.py``).

``Index.search`` delegates stage 1 (d2 scores over the compressed
database plus a per-query top-L) to a ``CandidateGenerator`` resolved
through the backend registry. Both ported backends declare
``streaming_topl`` and get ``StreamingTopL``: the (Q, N) score matrix is
never built, and the result is bit-identical to a stable sort of it.
``ops.adc_scan_topl`` picks the CUDA kernel or the plain stream by the
tensors' device.

The IVF faces (``gather_topl``, ``dispatch_topl``) are not ported yet.
"""
from __future__ import annotations

import abc

import torch

from repro_torch.index.backend import resolve_scan_backend
from repro_torch.kernels import merge, ops

_IMAX = torch.iinfo(torch.int32).max


class CandidateGenerator(abc.ABC):
    """Stage-1 strategy: codes + per-query LUTs -> top-L candidates."""

    @abc.abstractmethod
    def topl(self, codes, luts, bias, *, topl: int, qbias=None,
             lut_dtype: str = "float32", overfetch: int = 1):
        """codes (N, M), luts (Q, M, K), bias None | (N,), qbias
        None | (Q, N) -> (scores, indices), each (Q, min(topl, N)),
        sorted closest-first with ties toward the smaller index."""

    def gather_topl(self, *args, **kw):
        raise NotImplementedError(
            "the gathered (IVF) stage-1 face is not ported yet (ROADMAP A7)")

    def dispatch_topl(self, *args, **kw):
        raise NotImplementedError(
            "the cell-batched (IVF dispatch) stage-1 face is not ported yet "
            "(ROADMAP A7)")

    def __repr__(self):
        return f"{type(self).__name__}()"


class StreamingTopL(CandidateGenerator):
    """Streaming scan + top-L (``ops.adc_scan_topl``): O(Q * L) memory."""

    def topl(self, codes, luts, bias, *, topl: int, qbias=None,
             lut_dtype: str = "float32", overfetch: int = 1):
        return ops.adc_scan_topl(codes, luts, topl=topl, bias=bias,
                                 qbias=qbias, lut_dtype=lut_dtype,
                                 overfetch=overfetch)


def candidate_generator_for(device="cuda") -> CandidateGenerator:
    """The stage-1 generator of the backend ``device`` resolves to (which
    raises for a CUDA device without a card). Every ported backend
    declares ``streaming_topl``; the materialized generator of the
    reference's onehot backend comes with kernel 7 (ROADMAP B6)."""
    resolve_scan_backend("auto", device)
    return StreamingTopL()


def merge_topl(scores: torch.Tensor, ids: torch.Tensor, topl: int):
    """Exact lexicographic (score asc, id asc) top-L over an UNSORTED
    candidate pool (Q, P), +inf entries canonicalized to id INT32_MAX
    first (the cross-shard merge of the reference)."""
    ids = torch.where(torch.isposinf(scores), _IMAX, ids)
    return merge.lex_topl(scores, ids, topl)
