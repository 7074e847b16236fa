"""Checkpointing: tree <-> .npz with path-keyed arrays (port of
``repro/checkpoint/ckpt.py``: ``save`` / ``restore``).

The layout is the reference's: keys are '/'-joined paths (dict keys,
dataclass field names), and bf16 leaves are stored as a uint16 view under
``<path>__bf16__``.  A checkpoint of the reference's ``TrainState`` thus
restores into the port's (``train/loop.py``), and the reverse, exactly.
A packed weight store (``wq.PackedLinear``) is saved as the reference's
pytree node is: its ``codes``, ``scales``, ``mins`` and, when present,
``perm`` under ``<path>/<field>`` (JAX flattens a ``None`` child away);
its layout fields come from the template on restore.  A SplitLoRA
adapter checkpoint (``save_adapters`` / ``load_adapters``) holds the
adapter tree alone, in the same layout.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.wq.packed import PackedLinear

_BF16_TAG = "__bf16__"
_PACKED_CHILDREN = ("codes", "scales", "mins", "perm")


def _flatten(tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """('/'-joined path, leaf) pairs of dicts and dataclasses."""
    if isinstance(tree, PackedLinear):
        return [("/".join(prefix + (name,)), getattr(tree, name))
                for name in _PACKED_CHILDREN
                if getattr(tree, name) is not None]
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
    if isinstance(template, PackedLinear):
        return dataclasses.replace(template, **{
            name: leaves["/".join(prefix + (name,))]
            for name in _PACKED_CHILDREN
            if getattr(template, name) is not None})
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


def save_adapters(path: str, adapters: Any) -> None:
    """Save a SplitLoRA adapter tree, and nothing else: every leaf's path
    must end in ``lora_a`` / ``lora_b`` (``peft.init_lora_params``'s
    layout), so the file stays the adapters' size, not the model's."""
    flat = _flatten(adapters)
    if not flat:
        raise ValueError("empty adapter tree")
    for key, _ in flat:
        if key.rsplit("/", 1)[-1] not in ("lora_a", "lora_b"):
            raise ValueError(f"not an adapter tree: leaf {key!r} is not a "
                             "lora_a / lora_b entry")
    save(path, adapters)


def load_adapters(path: str, template: Any) -> Any:
    """Restore an adapter tree saved by :func:`save_adapters` into the
    structure of ``template`` (``init_lora_params(...)`` or
    ``params["adapters"]``), bit for bit (bf16 through its uint16 view)."""
    return restore(path, template)
