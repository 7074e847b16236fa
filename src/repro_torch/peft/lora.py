"""LoRA adapters over the stack executor's parameter trees (port of
``repro/peft/lora.py``).

SplitLoRA composes split learning with low-rank adapters: each side of the
cut fine-tunes only rank-``r`` factors ``A @ B`` added to its frozen
projection weights, which shrinks the optimizer state and the checkpoint.

A LoRA site is the weight-quantization site (``utils/tree.py``,
``is_weight_site``): a leaf whose dict key starts with ``"w"`` and that has
two or more axes, the last two read as ``(d_in, d_out)`` and any in front
(layer or stage stacking) as batch.  Adapters live in a nested dict that
mirrors the host tree: each site ``w`` becomes ``{"lora_a": A, "lora_b":
B}``, ``A (*batch, d_in, r)`` drawn from N(0, 1/d_in), ``B (*batch, r,
d_out)`` zero, so step 0 is the base model.

``apply_lora`` and ``merge_lora`` run one code path, so merged weights are
bit-identical to the effective weights a training forward used, and
serving merged params is token-exact against the adapter forward.
``unmerge_lora`` subtracts the same delta (the base back to rounding, not
bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.utils.tree import (is_weight_site, tree_flatten_with_path,
                                    tree_leaves, weight_sites)

Path = Tuple[str, ...]

# the one structural site rule, shared with weight-only quantization
is_lora_site = is_weight_site


def lora_sites(tree) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` for every LoRA site of ``tree`` (sorted keys, the
    reference's order)."""
    return weight_sites(tree)


def _nest_set(d: Dict, path: Path, value) -> None:
    for name in path[:-1]:
        d = d.setdefault(name, {})
    d[path[-1]] = value


def _adapter_tree(tree, rank: int, a_leaf, b_leaf) -> Dict:
    """The adapter tree mirroring ``tree``'s LoRA sites, site by site (A
    then B): ``a_leaf(shape, w)`` / ``b_leaf(shape, w)`` make the leaves
    of site ``w``."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    sites = lora_sites(tree)
    if not sites:
        raise ValueError("no LoRA sites (w*, ndim>=2) in tree")
    adapters: Dict = {}
    for path, w in sites:
        a = a_leaf(tuple(w.shape[:-1]) + (rank,), w)
        b = b_leaf(tuple(w.shape[:-2]) + (rank, w.shape[-1]), w)
        _nest_set(adapters, path, {"lora_a": a, "lora_b": b})
    return adapters


def init_lora_params(gen: torch.Generator, tree, rank: int, *,
                     b_scale: float = 0.0) -> Dict:
    """The adapter tree mirroring ``tree``'s LoRA sites: ``A ~ N(0,
    1/d_in)``, ``B = 0`` (or N(0, b_scale^2) when a test wants a nonzero
    delta), both in the site's dtype on the site's device, drawn in fp32
    from ``gen`` (site by site, A then B).  The draws are not the
    reference's ``jax.random`` ones; tests carry the reference's adapters
    across with ``repro_torch.bridge.from_jax_params``."""
    def normal(shape, scale, like):
        x = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (x * scale).to(like.dtype).to(like.device)

    def b_leaf(shape, w):
        return normal(shape, b_scale, w) if b_scale else \
            torch.zeros(shape, dtype=w.dtype, device=w.device)

    return _adapter_tree(tree, rank,
                         lambda shape, w: normal(shape, w.shape[-2] ** -0.5,
                                                 w), b_leaf)


def lora_shapes(tree, rank: int) -> Dict:
    """The adapter tree :func:`init_lora_params` makes for ``tree``, as
    ``meta`` tensors: its shapes and dtypes, with no numbers drawn."""
    def empty(shape, w):
        return torch.empty(shape, dtype=w.dtype, device="meta")

    return _adapter_tree(tree, rank, empty, empty)


def lora_delta(site: Dict, scale: float) -> torch.Tensor:
    """``scale * A @ B`` with the leading axes batched, the product in
    fp32, cast back to A's dtype."""
    a, b = site["lora_a"], site["lora_b"]
    d = torch.matmul(a.float(), b.float())
    return (scale * d).to(a.dtype)


def _adapter_map(adapters) -> Dict[Path, Dict]:
    """Site path -> ``{"lora_a", "lora_b"}`` of an adapter tree."""
    sites: Dict[Path, Dict] = {}
    for path, leaf in tree_flatten_with_path(adapters):
        if not path or path[-1] not in ("lora_a", "lora_b"):
            raise ValueError(f"not an adapter tree: leaf {path}")
        sites.setdefault(path[:-1], {})[path[-1]] = leaf
    return sites


def _fold(tree, adapters, scale: float, sign: int):
    sites = _adapter_map(adapters)
    seen = set()

    def walk(node, path: Path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        site = sites.get(path)
        if site is None:
            return node
        seen.add(path)
        return (node + sign * lora_delta(site, scale)).to(node.dtype)

    out = walk(tree, ())
    missing = set(sites) - seen
    if missing:
        raise ValueError(f"adapter sites missing from tree: {missing}")
    return out


def apply_lora(tree, adapters, *, scale: float = 1.0):
    """Effective weights ``w + scale * A @ B`` (the merge's arithmetic),
    differentiable in the adapters: a training forward runs on them with
    the base leaves frozen.  ``scale`` 1.0 is ``alpha == rank``."""
    return _fold(tree, adapters, scale, +1)


def merge_lora(tree, adapters, *, scale: float = 1.0):
    """Fold the adapters into the base weights for serving; the same
    arithmetic as :func:`apply_lora`, so the same bits."""
    return _fold(tree, adapters, scale, +1)


def unmerge_lora(tree, adapters, *, scale: float = 1.0):
    """Subtract the adapter delta (the base back to rounding)."""
    return _fold(tree, adapters, scale, -1)


def adapter_param_count(adapters) -> int:
    return sum(a.numel() for a in tree_leaves(adapters))


def adapter_bytes(adapters) -> int:
    return sum(a.numel() * a.element_size() for a in tree_leaves(adapters))
