"""Quantizer API + registry (port of ``repro/core/quantizers/base.py``).

Every compression method is three functions dispatched on
``QuantConfig.method``:

``encode(cfg, x, rng=None, impl=None) -> payload``   the wire form;
``decode(cfg, payload)               -> x_hat``     the server side;
``roundtrip(cfg, x, rng=None)        -> (x_hat, aux)``  the STE path.

``rng`` is a ``torch.Generator`` for the randomized quantizer (Top-K).

Backends: ``encode`` runs the fused-kernel codec (``kernel_codecs``,
registered as ``impl="kernel"``) unless the caller asks for
``impl="plain"``, the flat-stream encoders of the method modules.  The
kernel codec itself sends configs that no kernel covers to the plain
encoder by a static rule on the config.  On a CPU tensor the kernel codec
runs its kernels' plain PyTorch versions, so the choice is a wire layout,
not a device.  ``decode`` follows the payload's own ``meta["impl"]``.
``roundtrip`` is always plain PyTorch.

Grouped mixed precision: a config with a non-empty ``group_widths`` is an
allocation plan.  The channel (last) axis, gathered first into
``channel_perm`` order when one is set, splits into equal contiguous
groups; group g is encoded at ``group_widths[g]`` bits with its own
statistics, each group through the backend dispatch on its own, and the
wire form is a ``GroupedPayload``.  ``scale_dq`` ships the groups' fp16
scales as 8-bit codes against one shared (lo, hi) range.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.payload import GroupedPayload
from repro_torch.kernels.ref import div_exact

_VALID_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration for one compression method instance.

    Field for field and default for default the reference's
    ``repro.core.quantizers.QuantConfig``.
    """

    method: str = "rdfsq"  # fsq | rdfsq | nf | topk | identity
    bits: int = 2  # d = 2**bits discrete levels
    # --- NF-b (QLoRA) ---
    block_size: int = 64
    double_quant: bool = True
    dq_group: int = 256
    # --- RD-FSQ ---
    commit_alpha: float = 0.25
    clip_sigma: float = 3.0
    # --- Randomized Top-K ---
    rand_frac: float = 0.25
    # --- shared ---
    stats_axis: str = "sample"  # 'sample' (per batch row) | 'tensor'
    # --- grouped mixed precision (the adaptive wire's allocation plan) ---
    group_widths: Tuple[int, ...] = ()
    channel_perm: Tuple[int, ...] = ()
    scale_dq: bool = False

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def grouped(self) -> bool:
        return bool(self.group_widths)

    def group_cfgs(self) -> Tuple["QuantConfig", ...]:
        """One ungrouped per-group config (bits = that group's width)."""
        return tuple(dataclasses.replace(self, bits=w, group_widths=())
                     for w in self.group_widths)

    def mean_bits(self) -> float:
        """Average code width per scalar (equal groups)."""
        if not self.group_widths:
            return float(self.bits)
        return sum(self.group_widths) / len(self.group_widths)


_ENCODERS: Dict[str, Callable] = {}
_DECODERS: Dict[str, Callable] = {}
_ROUNDTRIPS: Dict[str, Callable] = {}
_BACKEND_ENCODERS: Dict[Tuple[str, str], Callable] = {}
_BACKEND_DECODERS: Dict[Tuple[str, str], Callable] = {}


def register(method: str, encode_fn, decode_fn, roundtrip_fn) -> None:
    """Register a method's plain encode/decode and its STE roundtrip."""
    _ENCODERS[method] = encode_fn
    _DECODERS[method] = decode_fn
    _ROUNDTRIPS[method] = roundtrip_fn


def register_backend(method: str, impl: str, encode_fn, decode_fn) -> None:
    """Register a fused-kernel encode/decode pair under ``impl``."""
    if impl not in _VALID_IMPLS:
        raise ValueError(f"unknown quantizer impl {impl!r}")
    _BACKEND_ENCODERS[(method, impl)] = encode_fn
    _BACKEND_DECODERS[(method, impl)] = decode_fn


def methods() -> Tuple[str, ...]:
    """Names of the registered quantizers."""
    return tuple(sorted(_ROUNDTRIPS))


def _method(table: Dict[str, Callable], method: str) -> Callable:
    if method not in table:
        raise ValueError(f"unknown quantizer {method!r}; registered: "
                         f"{sorted(table)}")
    return table[method]


# ---------------------------------------------------------------------------
# grouped mixed precision
# ---------------------------------------------------------------------------

def _group_splits(cfg: QuantConfig, d: int) -> int:
    """Validate the plan against the channel axis; returns group size."""
    g = len(cfg.group_widths)
    if d % g != 0:
        raise ValueError(f"channel axis {d} does not divide into {g} groups")
    bad = [w for w in cfg.group_widths if not 1 <= w <= 8]
    if bad:
        raise ValueError(f"group widths must be in [1, 8]: {bad}")
    return d // g


@functools.lru_cache(maxsize=16)
def _perm_index(perm: Tuple[int, ...], device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather, inverse) index tensors of a plan's permutation on
    ``device``: a plan is adopted once and shipped many times, so its
    index tensors are built once, not at every shipment."""
    fwd = torch.tensor(perm, dtype=torch.long)
    inv = torch.empty_like(fwd)
    inv[fwd] = torch.arange(len(perm))
    return fwd.to(device), inv.to(device)


def _apply_perm(cfg: QuantConfig, x: torch.Tensor) -> torch.Tensor:
    """Gather the channel axis into plan order (identity if unset)."""
    if not cfg.channel_perm:
        return x
    if len(cfg.channel_perm) != x.shape[-1]:
        raise ValueError(
            f"channel_perm has {len(cfg.channel_perm)} entries for a "
            f"{x.shape[-1]}-channel axis")
    return x.index_select(-1, _perm_index(cfg.channel_perm, x.device)[0])


def _invert_perm(cfg: QuantConfig, x: torch.Tensor) -> torch.Tensor:
    """Scatter the reassembled channel axis back to wire order."""
    if not cfg.channel_perm:
        return x
    return x.index_select(-1, _perm_index(cfg.channel_perm, x.device)[1])


def _dq_scales(groups):
    """8-bit double quantization of the groups' fp16 scale side info
    against one shared (lo, hi) range, shipped as a (2,) fp16
    ``scale_meta``.  Groups without scales (FSQ) or with integer scales
    (NF's own double quantization) pass through."""
    def eligible(g):
        return g.scales is not None and g.scales.is_floating_point()

    vals = [g.scales for g in groups if eligible(g)]
    if not vals:
        return tuple(groups), None
    flat = torch.cat([v.reshape(-1).float() for v in vals])
    lo, hi = flat.min(), flat.max()
    span = torch.clamp(hi - lo, min=1e-12)
    out = []
    for g in groups:
        if not eligible(g):
            out.append(g)
            continue
        codes = torch.round((g.scales.float() - lo) / span * 255.0
                            ).to(torch.uint8)
        out.append(dataclasses.replace(g, scales=codes,
                                       meta=dict(g.meta, scale_dq=True)))
    return tuple(out), torch.stack([lo, hi]).to(torch.float16)


def _undq_scales(payload: GroupedPayload):
    """Invert :func:`_dq_scales`: rebuild fp16 scales from uint8 codes."""
    lo = payload.scale_meta[0].float()
    hi = payload.scale_meta[1].float()
    span = torch.clamp(hi - lo, min=1e-12)
    out = []
    for g in payload.groups:
        if g.scales is None or not g.meta.get("scale_dq"):
            out.append(g)
            continue
        scales = (lo + div_exact(g.scales.float(), 255.0) * span
                  ).to(torch.float16)
        meta = {k: v for k, v in g.meta.items() if k != "scale_dq"}
        out.append(dataclasses.replace(g, scales=scales, meta=meta))
    return tuple(out)


def _group_rngs(rng: Optional[torch.Generator], n: int):
    """One generator per group, seeded from ``rng`` (the counterpart of
    ``jax.random.split``; the numbers differ from JAX's)."""
    if rng is None:
        return (None,) * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=rng,
                          device=rng.device).tolist()
    return tuple(torch.Generator(device=rng.device).manual_seed(s)
                 for s in seeds)


def encode_grouped(cfg: QuantConfig, x: torch.Tensor,
                   rng: Optional[torch.Generator] = None,
                   impl: Optional[str] = None) -> GroupedPayload:
    """Encode each channel group at its planned width, with its own
    statistics, through the backend dispatch."""
    gs = _group_splits(cfg, x.shape[-1])
    x = _apply_perm(cfg, x)
    rngs = _group_rngs(rng, len(cfg.group_widths))
    groups = [encode(sub, x[..., i * gs:(i + 1) * gs], r, impl)
              for i, (sub, r) in enumerate(zip(cfg.group_cfgs(), rngs))]
    groups, scale_meta = (_dq_scales(groups) if cfg.scale_dq
                          else (tuple(groups), None))
    return GroupedPayload(
        groups=groups, scale_meta=scale_meta,
        meta=dict(method=cfg.method, widths=tuple(cfg.group_widths),
                  group_size=gs, shape=tuple(x.shape), dtype=x.dtype,
                  permuted=bool(cfg.channel_perm)))


def decode_grouped(cfg: QuantConfig, payload: GroupedPayload
                   ) -> torch.Tensor:
    """Reassemble the channel axis from the per-group reconstructions."""
    groups = (_undq_scales(payload) if payload.scale_meta is not None
              else payload.groups)
    parts = [decode(sub, g) for sub, g in zip(cfg.group_cfgs(), groups)]
    return _invert_perm(cfg, torch.cat(parts, dim=-1))


def roundtrip_grouped(cfg: QuantConfig, x: torch.Tensor,
                      rng: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped STE roundtrip; the aux loss is the mean over groups."""
    gs = _group_splits(cfg, x.shape[-1])
    x = _apply_perm(cfg, x)
    fn = _method(_ROUNDTRIPS, cfg.method)
    rngs = _group_rngs(rng, len(cfg.group_widths))
    parts, auxes = [], []
    for i, (sub, r) in enumerate(zip(cfg.group_cfgs(), rngs)):
        xh, aux = fn(sub, x[..., i * gs:(i + 1) * gs], r)
        parts.append(xh)
        auxes.append(aux)
    return (_invert_perm(cfg, torch.cat(parts, dim=-1)),
            torch.stack(auxes).mean())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def encode(cfg: QuantConfig, x: torch.Tensor,
           rng: Optional[torch.Generator] = None,
           impl: Optional[str] = None):
    if cfg.grouped:
        return encode_grouped(cfg, x, rng, impl)
    impl = impl or "kernel"
    if impl not in _VALID_IMPLS:
        raise ValueError(f"unknown quantizer impl {impl!r}")
    fn = _BACKEND_ENCODERS.get((cfg.method, impl))
    if fn is not None:
        return fn(cfg, x, rng)
    return _method(_ENCODERS, cfg.method)(cfg, x, rng)


def decode(cfg: QuantConfig, payload) -> torch.Tensor:
    if isinstance(payload, GroupedPayload):
        return decode_grouped(cfg, payload)
    fn = _BACKEND_DECODERS.get((cfg.method, payload.meta.get("impl")))
    if fn is not None:
        return fn(cfg, payload)
    return _method(_DECODERS, cfg.method)(cfg, payload)


def roundtrip(cfg: QuantConfig, x: torch.Tensor,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.grouped:
        return roundtrip_grouped(cfg, x, rng)
    return _method(_ROUNDTRIPS, cfg.method)(cfg, x, rng)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def stats_axes(cfg: QuantConfig, ndim: int) -> Tuple[int, ...]:
    """Axes of the scaling statistics: per leading row, or the whole
    tensor."""
    if cfg.stats_axis == "sample":
        return tuple(range(1, ndim))
    if cfg.stats_axis == "tensor":
        return tuple(range(ndim))
    raise ValueError(f"unknown stats_axis {cfg.stats_axis!r}")


def symmetric_round(e: torch.Tensor, d: int) -> torch.Tensor:
    """Round e in [-1, 1] onto d symmetric levels (paper Alg. 1/2, l.3-6).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    half = (d - 1) / 2.0
    if d % 2 == 1:
        z = torch.round(half * e)
    else:
        z = torch.round(half * e - 0.5) + 0.5
    return torch.clamp(z, -half, half)
