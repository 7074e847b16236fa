"""Layer-stack executor (port of ``repro/models/stack.py``).

A segment's parameters are stacked on a leading layer axis, as in the
reference; its ``lax.scan`` becomes a Python loop over that axis.  The
layers are taken apart once with ``unbind``, so the gradient of the
stacked leaves is one stack of the per-layer gradients.

Execution policies, selected by keyword arguments of :func:`run_stack`:

* **plain loop**: ``remat=False``.
* **single-level remat**: ``remat=True``; each layer body runs under
  ``torch.utils.checkpoint`` (non-reentrant), so the backward stores only
  layer inputs and recomputes each layer's forward once.
* **two-level (sqrt-L) remat**: ``remat=True, remat_group=k>1``; groups of
  ``k`` layers are checkpointed as a whole and each layer inside them too,
  so the backward stores ``n/k`` group inputs plus the ``k`` layer inputs
  of the group in flight, and recomputes each layer's forward twice.
  Remainder layers (``n % k``) run through the single-level path.
* **cache collection**: ``collect=True`` also stacks the per-layer caches
  (serve path; never under remat).

The body contract is ``body(carry, p) -> (carry, (aux, cache))``: ``aux``
is a dict of per-layer scalars (may be ``{}``) and ``cache`` is ``None``
unless the caller collects caches.  ``run_stack`` returns ``(carry,
aux_summed_over_layers, caches_or_None)``.
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.wq.packed import PackedLinear

Body = Callable[[Any, Any], Tuple[Any, Tuple[Any, Any]]]

# Per-device byte budget for single-level-remat stored layer inputs before
# the auto-tuner switches a segment to two-level (sqrt-L) grouping; the
# reference's default and environment knob.
_DEFAULT_REMAT_BUDGET = 4 * 1024 ** 3


def auto_group_size(n: int, layer_bytes: int,
                    budget: Optional[int] = None) -> int:
    """Bytes-aware two-level-remat group size for an ``n``-layer segment.

    Single-level remat stores one carry per layer: ``n * layer_bytes``.
    When that fits ``budget`` (REPRO_REMAT_BUDGET_BYTES, default 4 GiB),
    stay single-level (returns 1).  Beyond it, ``k = round(sqrt(n))``
    minimizes the ``n/k`` group inputs + ``k`` in-flight layer inputs the
    two-level schedule stores.  An explicit ``cfg.remat_group`` wins.
    """
    if n < 4:
        return 1
    if budget is None:
        budget = int(os.environ.get("REPRO_REMAT_BUDGET_BYTES",
                                    _DEFAULT_REMAT_BUDGET))
    if n * layer_bytes <= budget:
        return 1
    return max(2, round(math.sqrt(n)))


def group_size(n: int, target: int = 8) -> int:
    """Inner group size <= target for sqrt-L remat (the ``n % k``
    remainder runs single-level)."""
    if n < 4:
        return 1
    return min(target, n)


def layer_forward_count(n: int, remat: bool, remat_group: int) -> int:
    """How many times the ``n`` layer bodies of one segment run in one
    forward + backward under the given policy."""
    if not remat:
        return n
    k = group_size(n, remat_group) if remat_group > 1 else 1
    if k == 1:
        return 2 * n
    m = (n // k) * k
    return 3 * m + 2 * (n - m)


def stack_len(stacked: Dict) -> int:
    """Leading (layer) axis length of a stacked parameter tree.

    These helpers take a layer-stacked ``PackedLinear`` (weight-only
    quantized serving) wherever they take a tensor leaf."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked dict-of-tensors tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_unbind(tree) -> List:
    """A stacked dict-of-tensors tree as a list of per-layer trees
    (views, no copies)."""
    if isinstance(tree, dict):
        per_key = {k: tree_unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, PackedLinear):
        return tree.unbind()
    return list(torch.unbind(tree))


def tree_stack(trees):
    """Stack a list of same-structure trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], PackedLinear):
        return PackedLinear.stack(trees)
    return torch.stack(trees)


def _tree_add(a: Dict, b: Dict) -> Dict:
    return {k: a[k] + b[k] for k in a}


def _run_layers(layer, carry, layers):
    """Run ``layer`` over a list of per-layer params; (carry, aux_sum,
    caches)."""
    aux_sum, caches = None, []
    for p in layers:
        carry, (aux, cache) = layer(carry, p)
        aux_sum = aux if aux_sum is None else _tree_add(aux_sum, aux)
        caches.append(cache)
    return carry, aux_sum, caches


def _checkpointed(fn):
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def run_stack(body: Body, carry, stacked: Dict, *, remat: bool = False,
              remat_group: int = 0, collect: bool = False):
    """Run ``body`` over the leading layer axis of ``stacked``.

    Returns ``(carry, aux_sum, caches)``: ``aux_sum`` is the per-layer aux
    dict summed over layers; ``caches`` is the layer-stacked cache tree
    when ``collect`` else ``None``.
    """
    layers = tree_unbind(stacked)
    n = len(layers)
    layer = _checkpointed(body) if remat else body

    k = group_size(n, remat_group) if remat_group > 1 else 1
    if remat and not collect and k > 1:
        m = (n // k) * k

        def group(c, ps):
            c, aux, _ = _run_layers(layer, c, ps)
            return c, aux

        run_group = _checkpointed(group)
        aux_sum = None
        for g0 in range(0, m, k):
            carry, aux = run_group(carry, layers[g0:g0 + k])
            aux_sum = aux if aux_sum is None else _tree_add(aux_sum, aux)
        if m < n:  # remainder layers: single-level remat
            carry, aux_r, _ = _run_layers(layer, carry, layers[m:])
            aux_sum = _tree_add(aux_sum, aux_r)
        return carry, aux_sum, None

    carry, aux_sum, caches = _run_layers(layer, carry, layers)
    return carry, aux_sum, (tree_stack(caches) if collect else None)


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
