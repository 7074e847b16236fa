"""Tree and numeric helpers (port of ``repro/utils/tree.py``:
``tree_bytes``, ``tree_count``, ``is_weight_site``, ``weight_sites``,
``ste``), and ``grads_or_zeros``, the port's ``jax.grad`` over a tree.

A tree here is a nested dict whose leaves are tensors (or anything else
that is not a dict); ``tree_map`` / ``tree_leaves`` stand in for
``jax.tree_util`` and visit dict keys in sorted order, as JAX does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over same-structure trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten_with_path(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_bytes(tree) -> int:
    """Total bytes of all tensor leaves of a tree; a packed weight store
    (``wq.PackedLinear``) counts its ``packed_bytes``."""
    from repro_torch.wq.packed import PackedLinear  # wq imports this module

    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, PackedLinear):
            total += x.packed_bytes()
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def tree_count(tree) -> int:
    """Total number of scalar parameters of a tree."""
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def is_weight_site(name: str, leaf) -> bool:
    """A projection weight: dict key ``w*`` with >= 2 dims.

    The one structural rule that selects weight-quantization sites and
    LoRA sites (``peft/lora.py``): the last two axes are read as ``(d_in,
    d_out)`` and any in front (layer axes) are batch.  Norm scales, biases
    and the codec's ``enc_b`` / ``dec_b`` are skipped.
    """
    return name.startswith("w") and getattr(leaf, "ndim", 0) >= 2


def weight_sites(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` for every weight site in ``tree`` (sorted keys)."""
    return [(path, leaf) for path, leaf in tree_flatten_with_path(tree)
            if path and is_weight_site(path[-1], leaf)]


def ste(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward value ``x + (x_hat - x)``,
    gradient of the identity.

    Written literally, as the reference writes it: in bf16 the sum is not
    bit-equal to ``x_hat``, and the port must round where the reference
    rounds.
    """
    return x + (x_hat - x).detach()


def grads_or_zeros(loss: torch.Tensor, leaves):
    """d loss / d leaf for every leaf of the tree ``leaves``; a leaf the
    loss does not reach gets a zero gradient, as in JAX."""
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)}
    return tree_map(lambda p: by_id[id(p)], leaves)
