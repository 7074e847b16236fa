"""Identity compressor, the paper's "Original Model" 16-bit baseline
(port of ``repro/core/quantizers/identity.py``): the wire carries bf16."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base


def encode(cfg: base.QuantConfig, x: torch.Tensor,
           rng: Optional[torch.Generator] = None) -> CommPayload:
    return CommPayload(
        data=x.to(torch.bfloat16),
        meta=dict(method="identity", impl="plain", bits=16,
                  shape=tuple(x.shape), dtype=x.dtype))


def decode(cfg: base.QuantConfig, payload: CommPayload) -> torch.Tensor:
    return payload.data.to(payload.meta["dtype"])


def roundtrip(cfg: base.QuantConfig, x: torch.Tensor,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (x.to(torch.bfloat16).to(x.dtype),
            torch.zeros((), dtype=torch.float32, device=x.device))


base.register("identity", encode, decode, roundtrip)
