"""Pluggable stage-1 candidate generation (the port of
``repro/index/candidates.py``).

``Index.search`` delegates stage 1 (d2 scores over the compressed
database plus a per-query top-L) to a ``CandidateGenerator`` resolved
through the backend registry:

  * ``StreamingTopL``     backends declaring ``streaming_topl`` (cuda,
                          torch): ``ops.adc_scan_topl``, the CUDA kernel or
                          the plain stream by the tensors' device. The
                          (Q, N) score matrix is never built.
  * ``MaterializedTopL``  the ``onehot`` backend: the full (Q, N) matrix
                          from ``ops.adc_scan_batch``, then a stable
                          top-L. Kept as the reference's A/B path.

Both give bit-identical (score, index) results, ties included, so the
choice is one of memory and speed, never of quality.

The IVF faces (``gather_topl``, ``dispatch_topl``) are not ported yet.
"""
from __future__ import annotations

import abc

import torch

from repro_torch.index.backend import backend_supports, resolve_scan_backend
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


#: queries per stable sort of the materialized matrix: bounds the sort's
#: (chunk, N) values and int64 indices beside the (Q, N) matrix
MATERIALIZED_SORT_QUERIES = 64


def _materialized_topl(codes, luts, bias, qbias, *, topl: int):
    """The (Q, N) score matrix (``ops.adc_scan_batch``, ``+ bias``, then
    ``+ qbias``, added in place), then a stable ascending sort per chunk
    of queries: ``lax.top_k``'s order, (score asc, index asc)."""
    scores = ops.adc_scan_batch(codes, luts)                # (Q, N)
    if bias is not None:
        scores += bias[None, :]
    if qbias is not None:
        scores += qbias
    vals, idx = [], []
    for s in range(0, scores.shape[0], MATERIALIZED_SORT_QUERIES):
        v, i = torch.sort(scores[s:s + MATERIALIZED_SORT_QUERIES], dim=1,
                          stable=True)
        vals.append(v[:, :topl])
        idx.append(i[:, :topl].to(torch.int32))
    return torch.cat(vals), torch.cat(idx)


class MaterializedTopL(CandidateGenerator):
    """The full (Q, N) score matrix + a stable top-L (the reference's
    pre-streaming stage 1; O(Q * N) peak memory)."""

    def topl(self, codes, luts, bias, *, topl: int, qbias=None,
             lut_dtype: str = "float32", overfetch: int = 1):
        if lut_dtype != "float32" or overfetch != 1:
            raise ValueError(
                f"{type(self).__name__} has no quantized-LUT path: its "
                "formulation is the materialized f32 matrix; gate callers "
                "on the 'quantized_lut' capability")
        return _materialized_topl(codes, luts, bias, qbias,
                                  topl=min(topl, codes.shape[0]))


def candidate_generator_for(device="cuda",
                            backend: str | None = "auto") -> CandidateGenerator:
    """The stage-1 generator of ``backend`` on ``device`` (resolving
    raises for a CUDA device without a card): ``StreamingTopL`` for a
    backend declaring ``streaming_topl``, else ``MaterializedTopL``."""
    name = resolve_scan_backend(backend, device)
    if backend_supports(name, "streaming_topl"):
        return StreamingTopL()
    return MaterializedTopL()


def merge_topl(scores: torch.Tensor, ids: torch.Tensor, topl: int):
    """Exact lexicographic (score asc, id asc) top-L over an UNSORTED
    candidate pool (Q, P), +inf entries canonicalized to id INT32_MAX
    first (the cross-shard merge of the reference)."""
    ids = torch.where(torch.isposinf(scores), _IMAX, ids)
    return merge.lex_topl(scores, ids, topl)
