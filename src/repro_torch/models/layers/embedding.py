"""Token embeddings and output heads, text and multi-codebook audio (port
of ``repro/models/layers/embedding.py``: ``embed``, ``embed_codebooks``
and ``head_logits``; the initial leaves are drawn by
``transformer.init_params``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A DTensor table (``launch/train.py --mesh``) is
    gathered whole for the lookup, as FSDP gathers every weight at its use,
    and read by ``F.embedding`` (ids sharded over the batch, the gradient
    a partial sum that reduces into the table's layout): DTensor's
    vocab-sharded lookup ends in a partial its reductions cannot convert,
    and indexing's backward (``index_put``) has no rule that holds on
    every torch the port runs on."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(table, DTensor):
        whole = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
        return F.embedding(ids, whole)
    return table[ids]


def embed(params: Dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return _rows(params["emb"].to(dtype), tokens.long())


def embed_codebooks(params: Dict, codes: torch.Tensor, dtype
                    ) -> torch.Tensor:
    """MusicGen's input: codes (B, K, S) through one table a codebook,
    ``params["emb"]`` (K, V, D), summed in codebook order -> (B, S, D).
    The sum starts as the reference's Python ``sum`` does (0 + the first
    codebook's rows), so the rounding in ``dtype`` is the same."""
    emb = params["emb"].to(dtype)
    codes = codes.long()
    return sum(_rows(emb[k], codes[:, k]) for k in range(codes.shape[1]))


def head_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) in x's dtype, or for an audio head
    ``params["w"]`` (K, D, V) one set of logits a codebook: (B, S, K,
    V)."""
    w = params["w"].to(x.dtype)
    if w.ndim == 3:
        return torch.einsum("bsd,kdv->bskv", x, w)
    return x @ w
