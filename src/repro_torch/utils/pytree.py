"""Named flattening of nested parameter containers (pure Python).

The port's counterpart of ``repro/utils/pytree.py``: the same ``"a/b/0/c"``
leaf names for the same nesting, so a checkpoint manifest written by one
package is read by the other. Dicts flatten in sorted-key order and lists
and tuples by position, as JAX's pytree flattening does; ``None`` is an
empty subtree with no leaf.
"""
from __future__ import annotations

from typing import Any


def tree_flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """Flatten nested dicts/lists/tuples to ``[("a/b/0/c", leaf), ...]``."""
    out: list[tuple[str, Any]] = []

    def walk(node, parts):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], parts + [str(key)])
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, parts + [str(i)])
        else:
            out.append(("/".join(parts), node))

    walk(tree, [])
    return out


def tree_unflatten_like(like: Any, leaves: list) -> Any:
    """Rebuild ``like``'s nesting with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    return build(like)
