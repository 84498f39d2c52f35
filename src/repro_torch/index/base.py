"""The ``Index`` protocol (the port of ``repro/index/base.py``): a
FAISS-style object that owns a compressed database you can query.

    index = index_factory("OPQ8x256,Rerank500", dim=96)   # device="cuda"
    index.train(train_vectors)        # PQ/OPQ; UNQ: from_trained (A4)
    index.add(base_vectors)           # compress + append to the database
    D, I = index.search(queries, k)   # two-stage compressed-domain search
    index.save(path); index = Index.load(path)

Every implementation supplies the quantizer primitives (fit, encode,
LUT build, reconstruct); the two-stage search itself, a streaming ADC scan
with a per-query top-L (d2, Eq. 8) and then an exact-reconstruction
rerank (d1, Eq. 7), is written once here. Stage 1 is a
``CandidateGenerator`` and stage 2 a ``Reranker``, both resolved through
the backend registry. An index lives on one device (``device=``,
default ``"cuda"``); its codes and model stay there and results come
back there. Its scan backend is the device's default, or the
materialized ``"onehot"`` that ``Scan(onehot)`` in the factory string
pins (``save``/``load`` keep it).

Not ported yet: training UNQ (ROADMAP A4) and the ``use_d2=False``
exhaustive-rerank ablation (ROADMAP A3).
"""
from __future__ import annotations

import abc
import json
import pathlib
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.manager import load_pytree, save_pytree
from repro_torch.index.backend import backend_supports, resolve_scan_backend
from repro_torch.index.candidates import candidate_generator_for
from repro_torch.kernels import lut_quant
from repro_torch.utils.device import resolve_device

# kind -> Index subclass, populated by __init_subclass__
_KINDS: dict[str, type["Index"]] = {}


def loaded_backend(meta: dict) -> str:
    """The backend a loaded index takes from its saved metadata: a saved
    ``onehot`` stays pinned; any other name (the reference's ``xla`` or
    ``pallas``, or "auto") gives way to the device's default."""
    return "onehot" if meta.get("backend") == "onehot" else "auto"


class Index(abc.ABC):
    """Abstract compressed-database index (see module docstring)."""

    kind: str = "abstract"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.kind != "abstract":
            _KINDS[cls.kind] = cls

    #: encode-batch ladder: ``add`` pads inputs up to the next bucket so
    #: differently-sized chunks reuse a few encoder shapes (the ladder
    #: then continues in 8192-row multiples)
    ENCODE_BUCKETS = (256, 1024, 4096, 8192)

    def __init__(self, dim: int, *, rerank: int = 0, backend: str = "auto",
                 device: str | torch.device = "cuda"):
        self.dim = dim
        self.rerank = rerank          # L: stage-2 candidates (0 = ADC only)
        self.device = resolve_device(device)
        # "auto" resolves by the device; "onehot" pins the materialized scan
        self.backend = resolve_scan_backend(backend, self.device)
        self._codes: torch.Tensor | None = None      # (N, M) uint8

    # -- database state ----------------------------------------------------

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else int(self._codes.shape[0])

    @property
    def codes(self) -> torch.Tensor | None:
        """The compressed database, (ntotal, M) uint8, on ``device``."""
        return self._codes

    @property
    @abc.abstractmethod
    def is_trained(self) -> bool:
        ...

    def train(self, xs, **kw) -> "Index":
        """Fit the index on (n, dim) training vectors; returns self.
        Keyword arguments go to ``_fit_quantizer`` (``seed=``,
        ``iters=``, ...), which moves ``xs`` to the index's device."""
        self._fit_quantizer(xs, **kw)
        return self

    @abc.abstractmethod
    def _fit_quantizer(self, xs, **kw) -> None:
        """Fit this index's own quantizer."""

    # -- quantizer primitives (implementation-specific) --------------------

    @abc.abstractmethod
    def _encode(self, xs: torch.Tensor) -> torch.Tensor:
        """(n, dim) -> (n, M) uint8 codes."""

    @abc.abstractmethod
    def _build_luts(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, dim) -> (Q, M, K) float32 additive score tables."""

    @abc.abstractmethod
    def _reconstruct(self, codes: torch.Tensor) -> torch.Tensor:
        """(n, M) codes -> (n, dim) reconstructions for stage 2."""

    def _decode_table(self) -> torch.Tensor | None:
        """(M, K, D) f32 additive decode table with ``recon = sum_m
        table[m, code_m]`` (``ref.decode_with_table``), or None when
        reconstruction needs a learned decoder (UNQ): stage 2 then
        dedups candidates instead of running the fused table kernel.
        Built from the current model on each call."""
        return None

    # -- add / search ------------------------------------------------------

    @classmethod
    def _encode_bucket(cls, n: int) -> int:
        """Smallest encode-batch bucket >= n (see ENCODE_BUCKETS)."""
        for b in cls.ENCODE_BUCKETS:
            if n <= b:
                return b
        step = cls.ENCODE_BUCKETS[-1]
        return -(-n // step) * step

    def add(self, xs) -> "Index":
        """Compress (n, dim) vectors and append them to the database.

        Inputs are zero-padded up to the next ``ENCODE_BUCKETS`` size
        before encoding (pad rows sliced off after). Encoders are
        row-stable, so the codes are those of encoding unpadded.
        """
        if not self.is_trained:
            raise RuntimeError(f"{type(self).__name__}.add before train()")
        xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
        n = xs.shape[0]
        bucket = self._encode_bucket(n)
        if bucket != n:
            xs = F.pad(xs, (0, 0, 0, bucket - n))
        codes = self._encode(xs)[:n]
        self._codes = codes if self._codes is None else \
            torch.cat([self._codes, codes])
        return self

    def _lower_filter(self, filter_mask, num_queries: int):
        """Lower a boolean keep-mask to the two stage-1 bias streams.

        filter_mask: None | (ntotal,) | (Q, ntotal) bool (True = keep).
        Returns (bias, qbias): the per-point (N,) stream (0 kept, +inf
        filtered) for a shared mask and the per-(query, point) (Q, N)
        stream for per-query masks. Uses ``where`` rather than addition
        so kept points' scores are bit-identical to an index built over
        only the kept points. (The reference also folds a per-point
        quantizer bias in here; no ported quantizer has one yet.)
        """
        if filter_mask is None:
            return None, None
        mask = torch.as_tensor(filter_mask, dtype=torch.bool,
                               device=self.device)
        zero = torch.zeros((), device=self.device)
        inf = torch.tensor(float("inf"), device=self.device)
        if mask.ndim == 1:
            if tuple(mask.shape) != (self.ntotal,):
                raise ValueError(f"filter_mask shape {tuple(mask.shape)} != "
                                 f"({self.ntotal},)")
            return torch.where(mask, zero, inf), None
        if tuple(mask.shape) != (num_queries, self.ntotal):
            raise ValueError(f"filter_mask shape {tuple(mask.shape)} != "
                             f"({num_queries}, {self.ntotal})")
        return None, torch.where(mask, zero, inf)

    def _check_quantized_request(self, lut_dtype: str, overfetch: int):
        """Gate a ``lut_dtype``/``overfetch`` request on the backend's
        ``quantized_lut`` capability (loud, not a silent f32 scan)."""
        lut_quant.check_lut_dtype(lut_dtype)
        if lut_dtype == "float32" and overfetch == 1:
            return
        if not backend_supports(self.backend, "quantized_lut"):
            raise ValueError(
                f"backend {self.backend!r} does not declare the "
                f"'quantized_lut' capability; lut_dtype={lut_dtype!r} / "
                f"overfetch={overfetch} need a streaming backend")

    def _saved_backend(self) -> str:
        """The backend name ``save`` records: a pinned ``onehot`` (which
        both packages have), else "auto", so each package picks its own
        by its device (``loaded_backend`` reads it back)."""
        return "onehot" if self.backend == "onehot" else "auto"

    def search(self, queries, k: int, *, use_rerank: bool | None = None,
               use_d2: bool = True, filter_mask=None,
               lut_dtype: str = "float32", overfetch: int = 1):
        """Two-stage search: (Q, dim) queries -> (distances, indices), each
        (Q, k) on the index's device, sorted closest-first.

        ``use_rerank=None`` reranks iff the index has a rerank budget;
        ``use_rerank=False`` returns the raw d2 ranking. ``filter_mask``
        ((ntotal,) or (Q, ntotal) bool, True = eligible) lowers to a
        +inf bias stream through stage 1, so a filtered point never
        enters the pool; when fewer than k points survive, the tail is
        (distance=+inf, index=-1).

        ``lut_dtype`` in {'float16', 'int8'} (with ``overfetch`` >= 1)
        opts stage 1 into the reduced-precision path: the scan selects
        ``overfetch * L`` candidates under quantized tables and the pool
        is re-scored with the exact f32 chain before the final top-L
        (``repro_torch.kernels.lut_quant``). Only backends with the
        ``quantized_lut`` capability accept it (``onehot`` raises
        ValueError); the default is the bit-exact f32 path, unchanged.
        """
        if self.ntotal == 0:
            raise RuntimeError("search on an empty index (call add first)")
        self._check_quantized_request(lut_dtype, overfetch)
        if not use_d2:
            raise NotImplementedError(
                "use_d2=False (exhaustive rerank over the database) is not "
                "ported yet (ROADMAP A3)")
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        if use_rerank is None:
            use_rerank = self.rerank > 0
        if use_rerank and self.rerank <= 0:
            raise ValueError(
                f"{type(self).__name__} has no rerank budget (rerank=0); "
                "set index.rerank or pass use_rerank=False")
        topl = min(self.rerank if use_rerank else k, self.ntotal)
        luts = self._build_luts(queries)
        gen = candidate_generator_for(self.device, self.backend)
        bias, qbias = self._lower_filter(filter_mask, queries.shape[0])
        d2, cand = gen.topl(self._codes, luts, bias, topl=topl, qbias=qbias,
                            lut_dtype=lut_dtype, overfetch=overfetch)
        if not use_rerank:
            d, i = d2[:, :k], cand[:, :k]
            if filter_mask is not None:
                i = torch.where(torch.isposinf(d), -1, i)
            return d, i
        valid = torch.isfinite(d2) if filter_mask is not None else None
        return self._rerank_topk(queries, cand, k, valid=valid)

    def _rerank_topk(self, queries, cand, k: int, *, valid=None):
        """Stage-2 tail: d1 rerank of the candidate pool + final top-k.

        ``valid`` (Q, L) bool marks pool entries that are real candidates
        (filtered search can underfill the pool): invalid slots are
        clamped to row 0 for the gather, forced to d1=+inf, and reported
        as index -1. The top-k is a stable sort, so ties go to the
        earlier pool position, as ``lax.top_k`` breaks them."""
        if valid is not None:
            cand = torch.where(valid, cand, 0)
        d1 = self._rerank_distances(queries, cand)          # (Q, L)
        if valid is not None:
            d1 = torch.where(valid, d1, float("inf"))
        kk = min(k, d1.shape[1])
        d, order = torch.sort(d1, dim=1, stable=True)
        d, order = d[:, :kk], order[:, :kk]
        i = torch.gather(cand, 1, order)
        if valid is not None:
            i = torch.where(torch.isposinf(d), -1, i)
        return d, i

    def _rerank_distances(self, queries, cand) -> torch.Tensor:
        """Stage 2: d1 = ||q - recon||^2 over each query's candidates,
        through the resolved ``Reranker`` (``repro_torch.index.rerank``)."""
        from repro_torch.index.rerank import reranker_for
        return reranker_for(self).distances(self, queries, cand)

    # -- persistence (the reference's checkpoint format) -------------------

    @abc.abstractmethod
    def _tree(self) -> Any:
        """Nested dict of everything save/load round-trips, with the
        reference's leaf names."""

    @abc.abstractmethod
    def _metadata(self) -> dict:
        """JSON-serializable config sufficient to rebuild ``_tree``."""

    @classmethod
    @abc.abstractmethod
    def _empty_from_metadata(cls, meta: dict, device) -> "Index":
        """An index whose ``_tree`` has the saved structure (leaf values
        are placeholders until ``_set_tree``)."""

    @abc.abstractmethod
    def _set_tree(self, tree: Any) -> None:
        """Install a restored ``_tree`` (numpy leaves)."""

    def save(self, path) -> None:
        """Atomic save to a checkpoint directory the reference can load
        (``repro.index.Index.load``) as well as this package."""
        metadata = {"index_kind": self.kind, "index_meta": self._metadata()}
        save_pytree(pathlib.Path(path), self._tree(), metadata=metadata)

    @staticmethod
    def load(path, *, device: str | torch.device = "cuda") -> "Index":
        """Load any saved index, the reference's included, onto
        ``device``, dispatching on the manifest's kind tag. A saved
        ``onehot`` backend is kept; any other saved name gives way to
        ``device``'s default backend."""
        path = pathlib.Path(path)
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        meta = manifest["metadata"]
        kind = meta.get("index_kind")
        if kind not in _KINDS:
            raise ValueError(f"{path} is not a saved index (kind={kind!r}; "
                             f"known: {sorted(_KINDS)})")
        index = _KINDS[kind]._empty_from_metadata(meta["index_meta"], device)
        tree, _ = load_pytree(path, index._tree())
        index._set_tree(tree)
        return index

    def __repr__(self):
        return (f"{type(self).__name__}(dim={self.dim}, "
                f"ntotal={self.ntotal}, rerank={self.rerank}, "
                f"backend={self.backend!r}, device={str(self.device)!r}, "
                f"trained={self.is_trained})")
