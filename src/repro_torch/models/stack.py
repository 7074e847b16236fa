"""Layer-stack executor (port of ``repro/models/stack.py``: ``run_stack``
without remat, and ``run_decode_stack``).

A segment's parameters are stacked on a leading layer axis, as in the
reference; its ``lax.scan`` becomes a Python loop over that axis.  Remat
is a training-time policy and comes with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked dict-of-tensors tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_stack(trees):
    """Stack a list of same-structure trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_len(stacked: Dict) -> int:
    """Leading (layer) axis length of a stacked parameter tree."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def run_stack(body: Callable[[Any, Any], Tuple[Any, Any]], carry,
              stacked: Dict, *, collect: bool = False):
    """Run ``body(carry, p) -> (carry, cache)`` over the layer axis.

    Returns ``(carry, caches)``: the layer-stacked caches when
    ``collect``, else ``None``.
    """
    caches = []
    for i in range(stack_len(stacked)):
        carry, cache = body(carry, tree_index(stacked, i))
        if collect:
            caches.append(cache)
    return carry, (tree_stack(caches) if collect else None)


def run_decode_stack(body: Callable[[Any, Tuple[Any, Any]], Any], carry,
                     stacked: Dict, caches: Dict):
    """One-token decode over a stacked segment.

    ``body(carry, (p, cache)) -> carry`` updates layer ``i``'s cache in
    place through the views ``tree_index`` hands it, so the stacked
    ``caches`` come back updated.  Returns ``(carry, caches)``.
    """
    for i in range(stack_len(stacked)):
        carry = body(carry, (tree_index(stacked, i), tree_index(caches, i)))
    return carry, caches
