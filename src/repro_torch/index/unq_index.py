"""UNQ-backed Index (the port of ``repro/index/unq_index.py``): add = one
feed-forward encode pass (encoder MLP, then the fused ``unq_encode``
argmax), search = d2 LUT scan + d1 decoder rerank.

Persistence uses the reference's leaf names (``params/...``,
``state/...``, ``codes``), so ``Index.load`` opens a directory that
``repro`` saved, and ``repro`` opens one this package saved.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import unq
from repro_torch.index import base
from repro_torch.kernels import ops


def encode_database(model: unq.UNQ, xs: torch.Tensor, *,
                    batch_size: int = 8192) -> torch.Tensor:
    """Compress a base set: (N, D) -> uint8 codes (N, M), batched."""
    outs = []
    for s in range(0, xs.shape[0], batch_size):
        heads = model.encode_heads(xs[s:s + batch_size])
        outs.append(ops.unq_encode(heads, model.codebooks).to(torch.uint8))
    return torch.cat(outs)


def build_luts(model: unq.UNQ, queries: torch.Tensor) -> torch.Tensor:
    """(Q, D) queries -> (Q, M, K) tables of -<net(q)_m, c_mk> (d2, Eq. 8).
    A plain einsum: the reference leaves this contraction to XLA too."""
    return -model.head_logits(model.encode_heads(queries))


class UNQIndex(base.Index):
    """Unsupervised Neural Quantization index (Morozov & Babenko 2019)."""

    kind = "unq"

    def __init__(self, dim: int, *, num_codebooks: int = 8,
                 codebook_size: int = 256, rerank: int = 500,
                 cfg: unq.UNQConfig | None = None, backend: str = "auto",
                 device="cuda"):
        super().__init__(dim, rerank=rerank, backend=backend, device=device)
        self.cfg = cfg if cfg is not None else unq.UNQConfig(
            dim=dim, num_codebooks=num_codebooks,
            codebook_size=codebook_size)
        if self.cfg.dim != dim:
            raise ValueError(f"cfg.dim={self.cfg.dim} != dim={dim}")
        self.model: unq.UNQ | None = None

    @classmethod
    def from_trained(cls, model: unq.UNQ, *, codes=None, rerank: int = 500,
                     device="cuda") -> "UNQIndex":
        """Wrap an already-trained UNQ model (and optionally its codes).
        The model is moved to ``device`` in place (``nn.Module.to``)."""
        index = cls(model.cfg.dim, rerank=rerank, cfg=model.cfg,
                    device=device)
        index._set_model(model)
        if codes is not None:
            if not isinstance(codes, torch.Tensor):   # copy: may be read-only
                codes = torch.tensor(np.asarray(codes, np.uint8))
            index._codes = codes.to(device=index.device, dtype=torch.uint8)
        return index

    def _set_model(self, model: unq.UNQ) -> None:
        self.model = model.to(self.device).eval().requires_grad_(False)

    @property
    def is_trained(self) -> bool:
        return self.model is not None

    def _fit_quantizer(self, xs, **kw):
        raise NotImplementedError(
            "training UNQ is not ported yet (ROADMAP A4); build the index "
            "from a trained model (UNQIndex.from_trained)")

    def _encode(self, xs):
        return encode_database(self.model, xs)

    def _build_luts(self, queries):
        return build_luts(self.model, queries)

    def _reconstruct(self, codes):
        return self.model.decode_codes(codes)

    # -- persistence -------------------------------------------------------

    def _tree(self):
        codes = self._codes if self._codes is not None else \
            torch.zeros((0, self.cfg.num_codebooks), dtype=torch.uint8)
        params, state = unq.unq_to_jax(self.model)
        return {"params": params, "state": state, "codes": codes}

    def _metadata(self) -> dict:
        return {"cfg": dataclasses.asdict(self.cfg), "rerank": self.rerank,
                "backend": self._saved_backend(), "ntotal": self.ntotal}

    @classmethod
    def _empty_from_metadata(cls, meta: dict, device) -> "UNQIndex":
        cfg = unq.UNQConfig(**meta["cfg"])   # the reference's fields too
        index = cls(cfg.dim, rerank=meta["rerank"], cfg=cfg,
                    backend=base.loaded_backend(meta), device=device)
        # a placeholder of the saved shapes (PyTorch's default parameters,
        # not ``unq.init``): ``load`` reads only its leaf names
        index.model = unq.UNQ(cfg)
        return index

    def _set_tree(self, tree) -> None:
        self._set_model(unq.unq_from_jax(tree["params"], tree["state"],
                                         self.cfg))
        codes = torch.as_tensor(tree["codes"], dtype=torch.uint8,
                                device=self.device)
        self._codes = codes if codes.shape[0] else None
