"""Sharding rules for every parameter / batch / cache leaf (port of
``repro/sharding/specs.py``).

Axes: ``data`` shards batch (and optionally weights, FSDP-style),
``model`` shards heads / FFN hidden / experts / vocab, ``pod`` is folded
into data-parallel (and is the split-stage axis of
``launch/split_pipeline.py --ranks``).

A spec is the reference's per-dim tuple of mesh-axis names: ``None``
(replicated), one name, or a tuple of names (``("pod", "data")``).
``to_placements`` turns one into DTensor placements on a
``DeviceMesh``.  Rules are name-based on the leaf path; every candidate
sharded dim is checked for divisibility by the mesh axis size and falls
back to replication when it does not divide (8 KV heads on a 16-way
model axis).

``fsdp=True`` additionally shards the "other" dim of >=2-D weights over
``data``: the ZeRO-3-style mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

Axes = Dict[str, int]  # axis name -> size
Spec = Tuple  # per-dim entries: None | axis name | tuple of axis names


def _spec(entries) -> Spec:
    """A spec with each one-name tuple entry as that name, as the
    reference's ``PartitionSpec`` holds it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _axis(axes: Axes, name: str, dim: int) -> Optional[str]:
    return name if name in axes and _fits(dim, axes[name]) else None


def _col(shape, axes, fsdp) -> Spec:
    """(in, out) weight sharded on output dim; fsdp also shards input."""
    spec = [None] * len(shape)
    spec[-1] = _axis(axes, "model", shape[-1])
    if fsdp:
        spec[-2] = _axis(axes, "data", shape[-2])
    return tuple(spec)


def _row(shape, axes, fsdp) -> Spec:
    spec = [None] * len(shape)
    spec[-2] = _axis(axes, "model", shape[-2])
    if fsdp:
        spec[-1] = _axis(axes, "data", shape[-1])
    return tuple(spec)


_COL_NAMES = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b", "w_gate",
              "w_up", "w_in", "in_proj", "conv_w", "wr", "wg", "enc_w",
              "w1"}
_ROW_NAMES = {"wo", "w_down", "out_proj", "dec_w", "w2"}


def leaf_pspec(path_names: Sequence[str], shape: Tuple[int, ...],
               axes: Axes, *, fsdp: bool = False,
               stacked: bool = False) -> Spec:
    """The spec of one parameter leaf."""
    if stacked:  # leading layer axis from segment stacking
        inner = leaf_pspec(path_names, shape[1:], axes, fsdp=fsdp)
        return (None,) + inner
    name = path_names[-1]
    parent = path_names[-2] if len(path_names) > 1 else ""
    replicated = (None,) * len(shape)

    if len(shape) <= 1:
        return replicated  # norms, biases, scalars
    if name == "emb":
        if len(shape) == 3:  # (K, V, D) audio codebooks
            return (None, _axis(axes, "model", shape[1]),
                    _axis(axes, "data", shape[2]) if fsdp else None)
        return (_axis(axes, "model", shape[0]),
                _axis(axes, "data", shape[1]) if fsdp else None)
    if parent == "head" and name == "w":
        spec = [None] * len(shape)
        spec[-1] = _axis(axes, "model", shape[-1])
        if fsdp:
            spec[-2] = _axis(axes, "data", shape[-2])
        return tuple(spec)
    if parent == "ffn" and len(shape) == 3:  # MoE experts (E, D, F)/(E, F, D)
        # E over model (expert parallel) + d_model over data (FSDP)
        return (_axis(axes, "model", shape[0]),
                _axis(axes, "data", shape[1]) if fsdp else None, None)
    if name == "router":
        return (None, None)
    if name in _COL_NAMES:
        return _col(shape, axes, fsdp)
    if name in _ROW_NAMES:
        return _row(shape, axes, fsdp)
    # the rwkv6 small weights (maa_w1, decay_w1, u, ...) and the rest:
    # replicated
    return replicated


def _map_specs(tree, rule, prefix: Tuple[str, ...] = ()):
    """``rule(path, leaf)`` over a dict tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_specs(v, rule, prefix + (str(k),))
                for k, v in tree.items()}
    return rule(prefix, tree)


def param_pspecs(params, axes: Axes, *, fsdp: bool = False):
    """Specs for the whole parameter tree (leaves: anything with a
    ``shape``)."""

    def rule(names, leaf):
        stacked = any(n.startswith("seg") for n in names)
        return leaf_pspec(names, tuple(leaf.shape), axes, fsdp=fsdp,
                          stacked=stacked)

    return _map_specs(params, rule)


def opt_pspecs(opt_state, params_specs):
    """Adam moments share the parameter specs; step is replicated."""
    return dict(m=params_specs, v=params_specs, step=())


def _dp_size(axes: Axes, dp: Tuple[str, ...]) -> int:
    n = 1
    for a in dp:
        n *= axes.get(a, 1)
    return n


def _dp_or_none(axes: Axes, dp: Tuple[str, ...], dim: int):
    """Batch axis group if the dim divides; else replicate (e.g. B=1)."""
    return dp if dim % max(_dp_size(axes, dp), 1) == 0 else None


def batch_pspecs(batch, dp: Tuple[str, ...], axes: Optional[Axes] = None):
    """Shard every batch leaf on its leading (batch) dim when divisible.

    ``positions`` is per-sequence (not per-sample) and stays replicated.
    """

    def rule(names, leaf):
        nd = len(leaf.shape)
        if names[-1] == "positions":
            return (None,) * nd
        lead = _dp_or_none(axes, dp, leaf.shape[0]) if axes else dp
        return _spec((lead,) + (None,) * (nd - 1))

    return _map_specs(batch, rule)


def cache_pspecs(caches, dp: Tuple[str, ...], axes: Axes):
    """Caches: layer-stacked leaves (n, B, ...); shard batch + KV heads.

    KV head counts that do not divide the model axis fall back to
    sharding head_dim; an MLA latent (n, B, L, c) shards c, a mamba state
    (n, B, H, P, N) its heads.
    """

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = _dp_or_none(axes, dp, shape[1])
        if names[-1] in ("k", "v") and len(shape) == 5:
            # (n, B, L, KH, hd): prefer heads, fall back to head_dim
            head_ax = _axis(axes, "model", shape[3])
            if head_ax:
                spec[3] = head_ax
            else:
                spec[4] = _axis(axes, "model", shape[4])
        if names[-1] == "ckv" and len(shape) == 4:  # MLA latent (n,B,L,c)
            spec[3] = _axis(axes, "model", shape[3])
        if names[-1] == "state" and len(shape) == 5:  # mamba (n,B,H,P,N)
            spec[2] = _axis(axes, "model", shape[2])
        return _spec(spec)

    return _map_specs(caches, rule)


def state_pspecs(state, axes: Axes, *, fsdp: bool = False):
    """Specs for a ``TrainState(params, opt, step)``."""
    pspecs = param_pspecs(state.params, axes, fsdp=fsdp)
    return type(state)(params=pspecs, opt=opt_pspecs(state.opt, pspecs),
                       step=())


def mesh_axes(mesh) -> Axes:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def to_placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements on ``mesh`` for a spec: ``Shard(d)`` on each mesh
    dimension named by entry ``d`` (a tuple entry shards dim ``d`` over
    each of its axes, the first outermost), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in names:
                if not isinstance(out[names.index(a)], Replicate):
                    raise ValueError(f"axis {a!r} shards two dims of {spec}")
                out[names.index(a)] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` laid out by
    the same-structure spec tree ``specs``.  Every rank holds the whole
    leaf (made from one seed); each keeps only its shard."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(tree[k], specs[k], mesh) for k in tree}
    return distribute_tensor(tree, mesh, to_placements(specs, mesh))


def gather(tree):
    """Every DTensor leaf of ``tree`` as the whole tensor on every rank
    (``full_tensor``); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
