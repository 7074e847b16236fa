"""Normalization (port of ``repro/models/layers/norms.py``: ``rms_norm``
and ``group_norm``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf / torch.sqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               n_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last axis split into ``n_groups`` (the RWKV head
    norm), in fp32 with the population variance (``correction=0``, as
    ``jnp.var``), cast back to x's dtype."""
    xf = x.float()
    shape = xf.shape
    xg = xf.reshape(*shape[:-1], n_groups, shape[-1] // n_groups)
    mean = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.var(xg, dim=-1, keepdim=True, correction=0)
    xg = (xg - mean) / torch.sqrt(var + eps)
    out = xg.reshape(shape) * weight.float() + bias.float()
    return out.to(x.dtype)
