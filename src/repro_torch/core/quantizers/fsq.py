"""FSQ, Finite Scalar Quantization: the paper's Algorithm 1 (port of
``repro/core/quantizers/fsq.py``).

tanh scaling, symmetric rounding onto 2^bits levels, the STE for
gradients; the baseline RD-FSQ improves on.  Reconstruction inverts onto
[-1, 1] with ``/ ((d-1)/2)`` as Algorithm 2 line 9 does (the reference's
erratum note on Algorithm 1 line 11), then applies a fixed arctanh.  The
wire payload is the packed codes alone.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.packing import pack_bits, unpack_bits
from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base
from repro_torch.kernels.ref import div_exact
from repro_torch.utils.tree import ste

_ATANH_CLIP = 1.0 - 1e-4


def _quantize(cfg: base.QuantConfig, x: torch.Tensor) -> torch.Tensor:
    half = (cfg.levels - 1) / 2.0
    z = base.symmetric_round(torch.tanh(x.float()), cfg.levels)
    return (z + half).to(torch.uint8)  # I in {0, ..., d-1}


def _reconstruct(cfg: base.QuantConfig, idx: torch.Tensor) -> torch.Tensor:
    half = (cfg.levels - 1) / 2.0
    c = div_exact(idx.float() - half, half)  # back onto [-1, 1]
    return torch.atanh(torch.clamp(c, -_ATANH_CLIP, _ATANH_CLIP))


def encode(cfg: base.QuantConfig, x: torch.Tensor,
           rng: Optional[torch.Generator] = None) -> CommPayload:
    return CommPayload(
        data=pack_bits(_quantize(cfg, x), cfg.bits),
        meta=dict(method="fsq", impl="plain", bits=cfg.bits,
                  shape=tuple(x.shape), dtype=x.dtype))


def decode(cfg: base.QuantConfig, payload: CommPayload) -> torch.Tensor:
    shape = payload.meta["shape"]
    idx = unpack_bits(payload.data, cfg.bits, math.prod(shape)
                      ).reshape(shape)
    return _reconstruct(cfg, idx).to(payload.meta["dtype"])


def roundtrip(cfg: base.QuantConfig, x: torch.Tensor,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    x_hat = _reconstruct(cfg, _quantize(cfg, x)).to(x.dtype)
    return ste(x, x_hat), torch.zeros((), dtype=torch.float32,
                                      device=x.device)


base.register("fsq", encode, decode, roundtrip)
