"""``repro_torch.index`` — the port's public entry point: the flat UNQ,
PQ and OPQ indexes with the reference's ``train / add / search / save /
load`` surface.

    from repro_torch.index import index_factory, Index

    index = index_factory("UNQ8x256,Rerank500", dim=96)   # device="cuda"
    index = index_factory("OPQ8x256,Rerank500", dim=96)
    index = index_factory("OPQ8x256,Rerank500,Scan(onehot)", dim=96)
"""
from repro_torch.index.backend import (available_scan_backends,
                                       backend_capabilities,
                                       backend_supports,
                                       resolve_scan_backend)
from repro_torch.index.base import Index
from repro_torch.index.candidates import (CandidateGenerator,
                                          MaterializedTopL, StreamingTopL,
                                          candidate_generator_for,
                                          merge_topl)
from repro_torch.index.factory import index_factory
from repro_torch.index.pq_index import OPQIndex, PQIndex
from repro_torch.index.rerank import (DedupRerank, Reranker, TableRerank,
                                      VmapRerank, reranker_for)
from repro_torch.index.unq_index import UNQIndex

__all__ = ["Index", "UNQIndex", "PQIndex", "OPQIndex", "index_factory",
           "CandidateGenerator", "MaterializedTopL", "StreamingTopL",
           "candidate_generator_for",
           "merge_topl", "Reranker", "TableRerank", "DedupRerank",
           "VmapRerank", "reranker_for",
           "available_scan_backends", "backend_capabilities",
           "backend_supports", "resolve_scan_backend"]
