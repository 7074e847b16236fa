"""Checkpointing: tree <-> .npz with path-keyed arrays (port of
``repro/checkpoint/ckpt.py``: ``save`` / ``restore``).

The layout is the reference's: keys are '/'-joined paths (dict keys,
dataclass field names), and bf16 leaves are stored as a uint16 view under
``<path>__bf16__``.  A checkpoint of the reference's ``TrainState`` thus
restores into the port's (``train/loop.py``), and the reverse, exactly.
The adapter checkpoints (``save_adapters`` / ``load_adapters``) are
ROADMAP item M9.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_BF16_TAG = "__bf16__"


def _flatten(tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """('/'-joined path, leaf) pairs of dicts and dataclasses."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _flatten(getattr(tree, f.name), prefix + (f.name,))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves: Dict[str, Any],
               prefix: Tuple[str, ...] = ()):
    if dataclasses.is_dataclass(template) and not isinstance(template,
                                                             type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves,
                               prefix + (f.name,))
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any) -> None:
    arrays: Dict[str, np.ndarray] = {}
    for key, leaf in _flatten(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arrays[key + _BF16_TAG if bf16 else key] = _to_numpy(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def restore(path: str, template: Any) -> Any:
    """Restore into the structure of ``template``; each leaf lands on its
    template leaf's device, in the dtype the checkpoint stored."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    leaves = {}
    for key, leaf in _flatten(template):
        if key + _BF16_TAG in stored:
            arr = stored[key + _BF16_TAG]
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif key in stored:
            t = torch.from_numpy(np.array(stored[key]))
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                f"template {tuple(leaf.shape)}")
        leaves[key] = t.to(leaf.device)
    return _unflatten(template, leaves)
