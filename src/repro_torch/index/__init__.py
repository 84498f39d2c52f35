"""``repro_torch.index`` — the port's public entry point: the flat UNQ
index with the reference's ``add / search / save / load`` surface.

    from repro_torch.index import index_factory, Index

    index = index_factory("UNQ8x256,Rerank500", dim=96)   # device="cuda"
"""
from repro_torch.index.backend import (available_scan_backends,
                                       backend_capabilities,
                                       backend_supports,
                                       resolve_scan_backend)
from repro_torch.index.base import Index
from repro_torch.index.candidates import (CandidateGenerator, StreamingTopL,
                                          candidate_generator_for,
                                          merge_topl)
from repro_torch.index.factory import index_factory
from repro_torch.index.rerank import (DedupRerank, Reranker, VmapRerank,
                                      reranker_for)
from repro_torch.index.unq_index import UNQIndex

__all__ = ["Index", "UNQIndex", "index_factory", "CandidateGenerator",
           "StreamingTopL", "candidate_generator_for", "merge_topl",
           "Reranker", "DedupRerank", "VmapRerank", "reranker_for",
           "available_scan_backends", "backend_capabilities",
           "backend_supports", "resolve_scan_backend"]
