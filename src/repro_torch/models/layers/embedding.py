"""Token embeddings and output heads, text and multi-codebook audio (port
of ``repro/models/layers/embedding.py``: ``embed``, ``embed_codebooks``
and ``head_logits``; the initial leaves are drawn by
``transformer.init_params``)."""
from __future__ import annotations

from typing import Dict

import torch


def embed(params: Dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["emb"].to(dtype)[tokens.long()]


def embed_codebooks(params: Dict, codes: torch.Tensor, dtype
                    ) -> torch.Tensor:
    """MusicGen's input: codes (B, K, S) through one table a codebook,
    ``params["emb"]`` (K, V, D), summed in codebook order -> (B, S, D).
    The sum starts as the reference's Python ``sum`` does (0 + the first
    codebook's rows), so the rounding in ``dtype`` is the same."""
    emb = params["emb"].to(dtype)
    codes = codes.long()
    return sum(emb[k][codes[:, k]] for k in range(codes.shape[1]))


def head_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) in x's dtype, or for an audio head
    ``params["w"]`` (K, D, V) one set of logits a codebook: (B, S, K,
    V)."""
    w = params["w"].to(x.dtype)
    if w.ndim == 3:
        return torch.einsum("bsd,kdv->bskv", x, w)
    return x @ w
