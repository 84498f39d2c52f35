"""PQ and OPQ indexes (the port of ``repro/index/pq_index.py``): the
shallow baselines behind the same ``Index`` protocol as UNQ, so the
paper's method comparisons share one search path.

add = per-subspace nearest-centroid encode; search = the stage-1 scan
over squared-L2 LUTs (``adc_scan_topl``), then, with a rerank budget,
stage 2 through the decode table (``TableRerank`` ->
``ops.rerank_gather_dist``). Persistence uses the reference's leaf names
(``codebooks``, ``codes``, ``rotation``), so each package loads the
other's saved ``pq``/``opq`` indexes. RVQ waits for ROADMAP A5b.
"""
from __future__ import annotations

import torch

from repro_torch.core import baselines as bl
from repro_torch.index import base
from repro_torch.kernels import ref


class PQIndex(base.Index):
    """Product Quantization (Jegou et al. 2011). ADC-only by default
    (``rerank=0``, as FAISS's IndexPQ); a rerank budget re-ranks the
    top-L by reconstruction distance."""

    kind = "pq"

    def __init__(self, dim: int, *, num_books: int = 8,
                 book_size: int = 256, rerank: int = 0,
                 backend: str = "auto", device="cuda"):
        super().__init__(dim, rerank=rerank, backend=backend, device=device)
        if dim % num_books:
            raise ValueError(f"dim={dim} is not a multiple of "
                             f"num_books={num_books}")
        self.num_books = num_books
        self.book_size = book_size
        self.model: bl.PQModel | None = None

    @property
    def is_trained(self) -> bool:
        return self.model is not None

    def _train_tensor(self, xs) -> torch.Tensor:
        return torch.as_tensor(xs, dtype=torch.float32, device=self.device)

    def _fit_quantizer(self, xs, *, iters: int = 25, seed: int = 0, **_):
        gen = torch.Generator().manual_seed(seed)
        self.model = bl.train_pq(self._train_tensor(xs), self.num_books,
                                 self.book_size, iters, generator=gen)

    def _encode(self, xs):
        return self.model.encode(xs)

    def _build_luts(self, queries):
        # per-subspace squared-L2 tables; summed over m this is the exact
        # compressed-domain distance
        return self.model.lut(queries)

    def _decode_table(self):
        # each sub-codebook embedded in its D-slice (zero elsewhere); OPQ
        # folds the inverse rotation in, so the additive sum is decode()
        # in the original space
        m, k, d_sub = self.model.codebooks.shape
        table = self.model.codebooks.new_zeros((m, k, self.dim))
        for i in range(m):
            table[i, :, i * d_sub:(i + 1) * d_sub] = self.model.codebooks[i]
        if self.model.rotation is not None:
            table = table @ self.model.rotation.T
        return table

    def _reconstruct(self, codes):
        # the table decode (not model.decode): the one association every
        # stage-2 path shares
        return ref.decode_with_table(codes, self._decode_table())

    # -- persistence -------------------------------------------------------

    def _tree(self):
        codes = self._codes if self._codes is not None else \
            torch.zeros((0, self.num_books), dtype=torch.uint8)
        tree = {"codebooks": self.model.codebooks, "codes": codes}
        if self.model.rotation is not None:
            tree["rotation"] = self.model.rotation
        return tree

    def _metadata(self) -> dict:
        return {"dim": self.dim, "num_books": self.num_books,
                "book_size": self.book_size, "rerank": self.rerank,
                "backend": self._saved_backend(), "ntotal": self.ntotal,
                "has_rotation": self.model.rotation is not None}

    @classmethod
    def _empty_from_metadata(cls, meta: dict, device) -> "PQIndex":
        index = cls(meta["dim"], num_books=meta["num_books"],
                    book_size=meta["book_size"], rerank=meta["rerank"],
                    backend=base.loaded_backend(meta), device=device)
        d_sub = meta["dim"] // meta["num_books"]
        rot = torch.eye(meta["dim"]) if meta["has_rotation"] else None
        # placeholders of the saved structure: ``load`` reads the names
        index.model = bl.PQModel(
            torch.zeros((meta["num_books"], meta["book_size"], d_sub)),
            rotation=rot)
        return index

    def _set_tree(self, tree) -> None:
        def dev(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.model = bl.PQModel(
            dev(tree["codebooks"]),
            rotation=dev(tree["rotation"]) if "rotation" in tree else None)
        codes = dev(tree["codes"], torch.uint8)
        self._codes = codes if codes.shape[0] else None


class OPQIndex(PQIndex):
    """Optimized PQ (Ge et al. 2013): a learned rotation, then PQ."""

    kind = "opq"

    def _fit_quantizer(self, xs, *, outer_iters: int = 8,
                       kmeans_iters: int = 10, seed: int = 0, **_):
        gen = torch.Generator().manual_seed(seed)
        self.model = bl.train_opq(self._train_tensor(xs), self.num_books,
                                  self.book_size, outer_iters=outer_iters,
                                  kmeans_iters=kmeans_iters, generator=gen)
