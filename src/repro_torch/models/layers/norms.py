"""Normalization (port of ``repro/models/layers/norms.py::rms_norm``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf / torch.sqrt(var + eps)
    return (out * weight.float()).to(x.dtype)
