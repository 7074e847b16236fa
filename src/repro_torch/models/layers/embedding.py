"""Token embedding and output head (port of
``repro/models/layers/embedding.py``, text heads)."""
from __future__ import annotations

from typing import Dict

import torch


def embed(params: Dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["emb"].to(dtype)[tokens.long()]


def head_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) in x's dtype."""
    return x @ params["w"].to(x.dtype)
