"""Rotary position embeddings (port of ``repro/models/layers/rope.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape (..., dim // 2) for integer positions (...,)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs (x[..., 0::2], x[..., 1::2]) in fp32.

    x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2), broadcast over H.
    """
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    if cos.ndim == x.ndim - 2:  # (S, D/2) -> (S, 1, D/2)
        cos, sin = cos[:, None, :], sin[:, None, :]
    elif cos.ndim == x.ndim - 1:  # (B, S, D/2) -> (B, S, 1, D/2)
        cos, sin = cos[..., None, :], sin[..., None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)
