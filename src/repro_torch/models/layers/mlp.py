"""Feed-forward layers (port of ``repro/models/layers/mlp.py``): SwiGLU
and the GELU connector MLP."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def swiglu_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    up = x @ params["w_up"].to(dt)
    return (gate * up) @ params["w_down"].to(dt)


def mlp_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Two-layer GELU MLP, the vision -> language connector.  The GELU is
    the tanh approximation, ``jax.nn.gelu``'s default."""
    dt = x.dtype
    h = F.gelu(x @ params["w1"].to(dt) + params["b1"].to(dt),
               approximate="tanh")
    return h @ params["w2"].to(dt) + params["b2"].to(dt)
