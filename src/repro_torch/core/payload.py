"""What crosses the client/server wire (port of ``repro/core/payload.py``):
``CommPayload`` for one width, ``GroupedPayload`` for a mixed-width plan,
and ``bits_per_scalar``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


def _nbytes(a: torch.Tensor) -> int:
    return a.numel() * a.element_size()


@dataclasses.dataclass
class CommPayload:
    """Quantized activation payload.

    ``data`` holds the packed uint8 code words (Top-K: the kept fp16
    values; identity: the bf16 activations), ``scales`` the per-row or
    per-block scale side information, ``aux`` anything else on the wire
    (block minima, double-quant group scales, top-k indices).  ``meta``
    (shape, bits, method, impl) is session-handshake metadata and is not
    counted as wire bytes.
    """

    data: torch.Tensor
    scales: Optional[torch.Tensor] = None
    aux: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def wire_bytes(self) -> int:
        """Total bytes on the wire, from shapes and dtypes."""
        return int(sum(_nbytes(a) for a in self.arrays()))

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        out = [self.data]
        if self.scales is not None:
            out.append(self.scales)
        out.extend(self.aux.values())
        return tuple(out)


@dataclasses.dataclass
class GroupedPayload:
    """Mixed-precision wire form: one ``CommPayload`` per channel group.

    ``meta`` records the group geometry (widths, group size, shape).
    ``scale_meta`` is the (2,) fp16 (lo, hi) range of the double-quantized
    scale side information (``QuantConfig.scale_dq``), or ``None`` when
    the groups ship their scales in fp16.
    """

    groups: Tuple[CommPayload, ...]
    scale_meta: Optional[torch.Tensor] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def wire_bytes(self) -> int:
        """The sum over group payloads, plus the scale range if any."""
        total = sum(g.wire_bytes() for g in self.groups)
        if self.scale_meta is not None:
            total += _nbytes(self.scale_meta)
        return int(total)

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        out: Tuple[torch.Tensor, ...] = ()
        for g in self.groups:
            out += g.arrays()
        if self.scale_meta is not None:
            out += (self.scale_meta,)
        return out

    @property
    def widths(self) -> Tuple[int, ...]:
        return tuple(self.meta.get("widths", ()))


def bits_per_scalar(payload, n_scalars: int) -> float:
    """Average transmitted bits per original activation scalar (Table 2),
    for a ``CommPayload`` or a ``GroupedPayload``."""
    return payload.wire_bytes() * 8.0 / float(n_scalars)
