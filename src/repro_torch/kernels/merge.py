"""Exact lexicographic top-L merge of (score, gid) pairs, as plain torch.

The reference folds candidate blocks into its running top-L with a
bitonic network (``repro/kernels/merge.py``). The port's plain versions
fold with the same total order, (score asc, gid asc), taken by two
stable sorts: by gid first, then by score, so that among equal scores
the gid order survives. Scores compare as floats, so -0.0 and +0.0 are
equal and their tie goes to the smaller gid, as ``_lex_le`` does in the
reference. The CUDA kernel keeps its own merge network in
``csrc/topl_scan.cu``.
"""
from __future__ import annotations

import torch


def lex_topl(scores: torch.Tensor, gids: torch.Tensor, topl: int):
    """The first ``topl`` pairs of each row of an unsorted (rows, P) pool
    under (score asc, gid asc). Returns ((rows, L), (rows, L)) with
    L = min(topl, P)."""
    order = torch.sort(gids, dim=-1, stable=True).indices
    s = torch.gather(scores, -1, order)
    g = torch.gather(gids, -1, order)
    order = torch.sort(s, dim=-1, stable=True).indices[..., :topl]
    return torch.gather(s, -1, order), torch.gather(g, -1, order)


def merge_topl_pairs(heap_s, heap_g, cand_s, cand_g, topl: int):
    """Fold a candidate block into a (rows, L) heap: the exact top-``topl``
    of their union under (score asc, gid asc)."""
    return lex_topl(torch.cat([heap_s, cand_s], dim=-1),
                    torch.cat([heap_g, cand_g], dim=-1), topl)
