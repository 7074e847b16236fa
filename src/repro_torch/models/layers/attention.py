"""GQA attention: projections, RoPE, the flash prefill contract, the paged
KV pool and its decode step (port of
``repro/models/layers/attention.py``, bf16 KV caches only).

The attention math goes through ``kernels/attention_ops.py``: K1 for
prefill and K8 for decode on CUDA tensors, their plain versions on CPU
tensors.  The int8 KV cache (``bits=8``) is the K7/K9 slice and raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import attention_ops
from repro_torch.kernels.attention_ref import FAR
from repro_torch.models.layers.rope import apply_rope, rope_angles


def _check_bits(bits: int) -> None:
    if bits != 16:
        raise NotImplementedError(
            "the int8 KV cache is the K7/K9 slice (ROADMAP queue K)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, kv_valid_len: Optional[int] = None,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Online-softmax causal attention.

    q: (B, Sq, H, D); k: (B, Skv, KH, D); v: (B, Skv, KH, Dv).  q is
    pre-scaled by D^-1/2 in its own dtype before the padding; Sq and Skv
    are padded to the chunk with qpos = -2^30 (sees nothing) and kpos =
    +2^30 (seen by nothing), which also marks keys past ``kv_valid_len``.
    Returns (B, Sq, H, Dv) in q's dtype.
    """
    if not causal or q_offset != 0:
        raise NotImplementedError("flash path is causal / offset-0 only")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if positions is None:
        positions = torch.arange(sq, dtype=torch.int32, device=q.device)
    positions = positions.to(torch.int32)
    if kv_valid_len is None:
        kv_valid_len = skv
    chunk = min(q_chunk, kv_chunk, sq, skv)
    pad_q = (-sq) % chunk
    pad_kv = (-skv) % chunk
    qs = F.pad(q * torch.tensor(d ** -0.5, dtype=q.dtype),
               (0, 0, 0, 0, 0, pad_q))
    kp_arr = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    qpos = F.pad(positions, (0, pad_q), value=-FAR)
    n = min(sq, skv)
    kpos = torch.full((skv + pad_kv,), FAR, dtype=torch.int32,
                      device=q.device)
    kpos[:n] = positions[:n]
    kpos = torch.where(torch.arange(kpos.shape[0], device=q.device)
                       < kv_valid_len, kpos, FAR)
    out = attention_ops.flash(qs, kp_arr, vp, qpos, kpos, window)
    return out[:, :sq]


def _grouped_query(q: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, 1, H, D) -> pre-scaled (B, KH, G, D)."""
    b, _, h, d = q.shape
    return q.reshape(b, kh, h // kh, d) * torch.tensor(d ** -0.5,
                                                       dtype=q.dtype)


def decode_attention_paged(q, k_pool, v_pool, pos_pool, page_table, qpos, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a paged KV pool.

    q: (S, 1, H, D) one row per scheduler slot; pools (P, pg, KH, D/Dv);
    pos_pool (P, pg) (-1 empty); page_table (S, npp) (-1 unallocated);
    qpos (S,) with -1 for inactive slots (their output is 0).
    """
    s, _, h, _ = q.shape
    qf = _grouped_query(q, k_pool.shape[2])
    out = attention_ops.decode_paged(qf, k_pool, v_pool, pos_pool,
                                     page_table, qpos, window=window)
    return out.reshape(s, 1, h, v_pool.shape[-1]).to(q.dtype)


def _qkv(params: Dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
         head_dim: int):
    b, s, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, n_heads, head_dim)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def gqa_forward(params: Dict, x: torch.Tensor, *, n_heads: int,
                n_kv_heads: int, head_dim: int, rope_theta: float,
                positions: torch.Tensor, causal: bool = True,
                window: Optional[int] = None, return_kv: bool = False):
    """Full-sequence attention (prefill)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, head_dim)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, positions=positions, causal=causal,
                          window=window)
    y = out.reshape(b, s, n_heads * head_dim) @ params["wo"].to(x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode_paged(params: Dict, x: torch.Tensor, cache: Dict, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float, qpos: torch.Tensor,
                     page_table: torch.Tensor,
                     window: Optional[int] = None):
    """One decode tick against a paged KV pool.

    ``cache`` = {k, v, pos} pools (P, pg, ...).  Unlike the reference,
    which returns new pools, this writes the new token's K/V and position
    into ``cache`` IN PLACE and returns it.  Inactive (qpos = -1) or
    unallocated writes land on the reserved trash page 0 with pos = -1,
    so they are never attended to.  Returns (y, cache).
    """
    s = x.shape[0]
    pg = cache["k"].shape[1]
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, head_dim)
    cos, sin = rope_angles(qpos[:, None], head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qpos = qpos.long()
    active = qpos >= 0
    qp = torch.clamp_min(qpos, 0)
    phys = page_table.long()[torch.arange(s, device=x.device), qp // pg]
    phys = torch.where(active & (phys >= 0), phys, 0)
    off = qp % pg
    cache["pos"][phys, off] = torch.where(active, qpos, -1).to(
        cache["pos"].dtype)
    cache["k"][phys, off] = k[:, 0].to(cache["k"].dtype)
    cache["v"][phys, off] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention_paged(q, cache["k"], cache["v"], cache["pos"],
                                 page_table, qpos, window=window)
    y = out.reshape(s, 1, n_heads * head_dim) @ params["wo"].to(x.dtype)
    return y, cache


def init_kv_cache(batch: int, length: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, bits: int = 16,
                  device=None) -> Dict:
    """Contiguous ring cache (B, L, KH, hd), positions -1 (empty)."""
    _check_bits(bits)
    return dict(
        k=torch.zeros((batch, length, n_kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, length, n_kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device),
    )


def init_paged_kv_pool(n_pages: int, page_size: int, n_kv_heads: int,
                       head_dim: int, dtype=torch.bfloat16, bits: int = 16,
                       device=None) -> Dict:
    """(P, pg, ...) pools shared by every request; physical page 0 is the
    trash page, never handed to a request."""
    _check_bits(bits)
    return dict(
        k=torch.zeros((n_pages, page_size, n_kv_heads, head_dim),
                      dtype=dtype, device=device),
        v=torch.zeros((n_pages, page_size, n_kv_heads, head_dim),
                      dtype=dtype, device=device),
        pos=torch.full((n_pages, page_size), -1, dtype=torch.int32,
                       device=device),
    )
