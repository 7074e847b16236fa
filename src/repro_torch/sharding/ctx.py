"""Activation-sharding context (port of ``repro/sharding/ctx.py``).

The launcher (``launch/train.py --mesh``) installs rules; model code calls
``constrain(x, kind)`` at the reference's sites.  On a plain tensor, or
when no rules are installed (unit tests, single-device runs), every
function here returns its input unchanged.  On a ``DTensor`` it
``redistribute``s to the rule's layout on the tensor's own mesh: the
values never change, only where their pieces live.  Every sharded dim is
checked for divisibility against the mesh axis sizes and dropped when it
does not divide (16 MoE groups on a 32-way data axis).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.sharding.specs import to_placements
from repro_torch.utils.tree import tree_map

_RULES: Dict[str, Tuple] = {}
_AXES: Dict[str, int] = {}
_PARAM_SPECS = None  # spec tree matching the model params


def install(dp: Tuple[str, ...], axes: Optional[Dict[str, int]] = None,
            model: str = "model") -> None:
    """Install the standard rules for a (data..., model) mesh."""
    global _RULES, _AXES
    _AXES = dict(axes or {})
    _RULES = dict(
        hidden=(dp, None, None),              # (B, S, D) / (G, TG, D)
        logits=(dp, None, model),             # (B, S, V)
        batch_leading=(dp,),                  # generic leading batch dim
        moe_experts=(dp, model, None, None),  # (G, E, C, D)
        decode_q=(dp, None, None, model),     # (B, KH, G, hd)
    )


def set_param_specs(specs) -> None:
    """Register the parameter specs so gradient accumulators can be pinned
    to the same (FSDP) layout."""
    global _PARAM_SPECS
    _PARAM_SPECS = specs


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _place(x, spec):
    """``x`` redistributed to ``spec`` on its mesh (a DTensor), else x."""
    if not _is_dtensor(x):
        return x
    place = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == place:
        return x
    return x.redistribute(x.device_mesh, place)


def constrain_like_params(tree):
    if _PARAM_SPECS is None or not _RULES:
        return tree
    return tree_map(
        lambda a, spec: _place(a, _fit_spec(spec, a.shape))
        if hasattr(a, "ndim") and len(spec) == a.ndim else a,
        tree, _PARAM_SPECS)


def clear() -> None:
    global _RULES, _AXES, _PARAM_SPECS
    _RULES = {}
    _AXES = {}
    _PARAM_SPECS = None


def active() -> bool:
    return bool(_RULES)


def dp_size() -> int:
    n = 1
    for a in ("pod", "data"):
        n *= _AXES.get(a, 1)
    return n


def _axis_size(entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= _AXES.get(a, 1)
        return n
    return _AXES.get(entry, 1)


def _fit_spec(spec: Tuple, shape) -> Tuple:
    """Drop spec entries whose axis size does not divide the dim."""
    out = []
    for dim, entry in zip(shape, tuple(spec)):
        size = _axis_size(entry)
        out.append(entry if size > 1 and dim % size == 0 else None)
    return tuple(out)


def constrain(x, kind: str):
    spec = _RULES.get(kind)
    if spec is None or not hasattr(x, "ndim"):
        return x
    if kind == "batch_leading":
        spec = tuple(spec) + (None,) * (x.ndim - 1)
    if len(spec) != x.ndim:
        return x
    spec = _fit_spec(spec, x.shape)
    if all(e is None for e in spec):
        return x
    return _place(x, spec)


def constrain_kv(x, dp=("pod", "data")):
    """Pin a new KV token (B, KH, hd) to the ring-cache layout: heads over
    ``model`` when they divide, else head_dim over ``model``."""
    if not _RULES or x.ndim != 3:
        return x
    m = _AXES.get("model", 1)
    dp_t = tuple(a for a in dp if a in _AXES)
    b, kh, hd = x.shape
    lead = dp_t if dp_t and b % max(_axis_size(dp_t), 1) == 0 else None
    if m > 1 and kh % m == 0:
        spec = (lead, "model", None)
    elif m > 1 and hd % m == 0:
        spec = (lead, None, "model")
    else:
        spec = (lead, None, None)
    return _place(x, spec)


def constrain_latent(x, dp=("pod", "data")):
    """Pin a new MLA latent token (B, C) to the latent-cache layout."""
    if not _RULES or x.ndim != 2:
        return x
    m = _AXES.get("model", 1)
    dp_t = tuple(a for a in dp if a in _AXES)
    b, c = x.shape
    lead = dp_t if dp_t and b % max(_axis_size(dp_t), 1) == 0 else None
    return _place(x, (lead, "model" if m > 1 and c % m == 0 else None))


def constrain_batch_tree(tree):
    """Pin the leading batch dim of every tensor leaf."""
    if not _RULES:
        return tree
    return tree_map(lambda a: constrain(a, "batch_leading"), tree)
