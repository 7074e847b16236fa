"""CommPayload: what crosses the client/server wire (port of
``repro/core/payload.py``; ``GroupedPayload`` is ROADMAP item M8)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class CommPayload:
    """Quantized activation payload.

    ``data`` holds the packed uint8 code words, ``scales`` the per-row
    fp16 side information, ``aux`` anything else on the wire.  ``meta``
    (shape, bits, method, impl) is session-handshake metadata and is not
    counted as wire bytes.
    """

    data: torch.Tensor
    scales: Optional[torch.Tensor] = None
    aux: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def wire_bytes(self) -> int:
        """Total bytes on the wire, from shapes and dtypes."""
        def nbytes(a: torch.Tensor) -> int:
            return a.numel() * a.element_size()

        total = nbytes(self.data)
        if self.scales is not None:
            total += nbytes(self.scales)
        for v in self.aux.values():
            total += nbytes(v)
        return int(total)
