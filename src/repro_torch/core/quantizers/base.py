"""Quantizer API + registry (port of ``repro/core/quantizers/base.py``).

Every compression method is three functions dispatched on
``QuantConfig.method``:

``encode(cfg, x, impl=None) -> CommPayload``   the wire form;
``decode(cfg, payload)      -> x_hat``          the server reconstruction;
``roundtrip(cfg, x)         -> (x_hat, aux)``   the in-graph STE path.

Backends: ``encode`` runs the fused-kernel codec (``kernel_codecs``,
registered as ``impl="kernel"``) unless the caller asks for
``impl="plain"``, the flat-stream encoder of ``rdfsq.py``.  On a CPU tensor
the kernel codec runs its kernels' plain PyTorch versions, so the choice
is a wire layout, not a device.  ``decode`` follows the payload's own
``meta["impl"]``.  ``roundtrip`` is always plain PyTorch.

Left out of this slice: the grouped mixed-precision paths
(``group_widths`` / ``channel_perm`` / ``scale_dq``), which raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

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
    # --- grouped mixed precision (not in this slice) ---
    group_widths: Tuple[int, ...] = ()
    channel_perm: Tuple[int, ...] = ()
    scale_dq: bool = False

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def grouped(self) -> bool:
        return bool(self.group_widths)


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


def _check_ungrouped(cfg: QuantConfig) -> None:
    if cfg.grouped or cfg.channel_perm or cfg.scale_dq:
        raise NotImplementedError(
            "grouped mixed-precision wire is ROADMAP queue M, item M8")


def _method(table: Dict[str, Callable], method: str) -> Callable:
    if method not in table:
        raise NotImplementedError(
            f"quantizer {method!r} is not ported yet (ROADMAP queue M, "
            f"item M8); this slice has {sorted(table)}")
    return table[method]


def encode(cfg: QuantConfig, x: torch.Tensor, impl: Optional[str] = None):
    _check_ungrouped(cfg)
    impl = impl or "kernel"
    if impl not in _VALID_IMPLS:
        raise ValueError(f"unknown quantizer impl {impl!r}")
    fn = _BACKEND_ENCODERS.get((cfg.method, impl))
    if fn is not None:
        return fn(cfg, x)
    return _method(_ENCODERS, cfg.method)(cfg, x)


def decode(cfg: QuantConfig, payload) -> torch.Tensor:
    _check_ungrouped(cfg)
    fn = _BACKEND_DECODERS.get((cfg.method, payload.meta.get("impl")))
    if fn is not None:
        return fn(cfg, payload)
    return _method(_DECODERS, cfg.method)(cfg, payload)


def roundtrip(cfg: QuantConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_ungrouped(cfg)
    return _method(_ROUNDTRIPS, cfg.method)(cfg, x)


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
