"""GQA attention: projections, RoPE, the flash prefill contract, the ring
KV cache and the paged KV pool with their decode steps, bf16 or int8 (port
of ``repro/models/layers/attention.py``).

The attention math goes through ``kernels/attention_ops.py``: K1 for the
forward (K2 / K3 for its backward), K6 / K7 for decode against a ring
cache and K8 / K9 against a paged pool (bf16 / int8) on CUDA tensors,
their plain versions on CPU tensors.  The caches are written IN PLACE,
where the reference returns new ones from a donated jit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import attention_ops
from repro_torch.kernels.attention_ref import FAR
from repro_torch.kernels.ref import div_exact
from repro_torch.models.layers.rope import apply_rope, rope_angles
from repro_torch.sharding import ctx as shard_ctx


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
    qf = q.reshape(b, kh, h // kh, d) * torch.tensor(d ** -0.5,
                                                     dtype=q.dtype)
    return shard_ctx.constrain(qf, "decode_q")


def decode_attention(q, k_cache, v_cache, kpos, qpos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a ring cache (K6).

    q: (B, 1, H, D); caches (B, L, KH, D/Dv); kpos (B, L) absolute
    position of each slot (-1 empty); qpos (B,).
    """
    b, _, h, _ = q.shape
    qf = _grouped_query(q, k_cache.shape[2])
    out = attention_ops.decode(qf, k_cache, v_cache, kpos, qpos,
                               window=window)
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def decode_attention_q8(q, k_codes, v_codes, k_scale, v_scale, kpos, qpos, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against an int8 ring cache (K7); the scales
    fold into the dots: s = (q . codes) * k_scale; out = (p * v_scale) .
    codes."""
    b, _, h, d = q.shape
    qf = _grouped_query(q, k_codes.shape[2])
    out = attention_ops.decode_q8(qf, k_codes, v_codes, k_scale, v_scale,
                                  kpos, qpos, window=window)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_paged(q, k_pool, v_pool, pos_pool, page_table, qpos, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a paged KV pool (K8).

    q: (S, 1, H, D) one row per scheduler slot; pools (P, pg, KH, D/Dv);
    pos_pool (P, pg) (-1 empty); page_table (S, npp) (-1 unallocated);
    qpos (S,) with -1 for inactive slots (their output is 0).
    """
    s, _, h, _ = q.shape
    qf = _grouped_query(q, k_pool.shape[2])
    out = attention_ops.decode_paged(qf, k_pool, v_pool, pos_pool,
                                     page_table, qpos, window=window)
    return out.reshape(s, 1, h, v_pool.shape[-1]).to(q.dtype)


def decode_attention_paged_q8(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                              pos_pool, page_table, qpos, *,
                              window: Optional[int] = None) -> torch.Tensor:
    """Paged int8-pool decode (K9); the (P, pg, KH) fp16 scale pools fold
    into the dots exactly as in ``decode_attention_q8``."""
    s, _, h, d = q.shape
    qf = _grouped_query(q, k_pool.shape[2])
    out = attention_ops.decode_paged_q8(qf, k_pool, v_pool, k_scale_pool,
                                        v_scale_pool, pos_pool, page_table,
                                        qpos, window=window)
    return out.reshape(s, 1, h, d).to(q.dtype)


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
    q, k, v = (x @ params[w].to(x.dtype) for w in ("wq", "wk", "wv"))
    kv = []  # the rotated K and V, for return_kv

    def attend(q, k, v, positions):
        b, s, _ = q.shape
        q, k, v = (t.reshape(b, s, -1, head_dim) for t in (q, k, v))
        cos, sin = rope_angles(positions, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kv.append((k, v))
        out = flash_attention(q, k, v, positions=positions, causal=causal,
                              window=window)
        return out.reshape(b, s, -1)

    # under a mesh (DTensor q / k / v) on each rank's local heads
    out = attention_ops.on_local_heads(attend, q, k, v, positions,
                                       heads=(n_heads, n_kv_heads))
    y = out @ params["wo"].to(x.dtype)
    if return_kv:
        return y, kv[0]
    return y


def _decode_qkv(params: Dict, x: torch.Tensor, qpos: torch.Tensor,
                n_heads: int, n_kv_heads: int, head_dim: int,
                rope_theta: float):
    """The new token's q, k, v (R, 1, heads, hd), RoPE'd at qpos."""
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, head_dim)
    cos, sin = rope_angles(qpos[:, None], head_dim, rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def write_kv(cache: Dict, where, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K / V (..., KH, hd) at index ``where`` of the cache leaves, in
    place: in the cache's dtype, or for an int8 cache (one with
    ``k_scale``) as codes with fp16 scales."""
    if "k_scale" in cache:
        kc, cache["k_scale"][where] = quantize_kv_token(k)
        vc, cache["v_scale"][where] = quantize_kv_token(v)
        cache["k"][where] = shard_ctx.constrain_kv(kc)
        cache["v"][where] = shard_ctx.constrain_kv(vc)
    else:
        # the new token in the cache's layout before the scatter
        cache["k"][where] = shard_ctx.constrain_kv(k.to(cache["k"].dtype))
        cache["v"][where] = shard_ctx.constrain_kv(v.to(cache["v"].dtype))


def gqa_decode(params: Dict, x: torch.Tensor, cache: Dict, *, n_heads: int,
               n_kv_heads: int, head_dim: int, rope_theta: float,
               qpos: torch.Tensor, window: Optional[int] = None):
    """One-token decode against a ring cache {k, v, pos[, k_scale,
    v_scale]} (B, L, ...).

    The new token's K / V and position go to slot qpos mod L, IN PLACE
    (the reference returns a new cache).  A window smaller than the history
    masks by position, not by slot.  Returns (y, cache).
    """
    b = x.shape[0]
    q, k, v = _decode_qkv(params, x, qpos, n_heads, n_kv_heads, head_dim,
                          rope_theta)
    where = (torch.arange(b, device=x.device),
             qpos.long() % cache["k"].shape[1])
    cache["pos"][where] = qpos.to(cache["pos"].dtype)
    write_kv(cache, where, k[:, 0], v[:, 0])
    if "k_scale" in cache:
        out = decode_attention_q8(q, cache["k"], cache["v"],
                                  cache["k_scale"], cache["v_scale"],
                                  cache["pos"], qpos, window=window)
    else:
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"], qpos,
                               window=window)
    y = out.reshape(b, 1, n_heads * head_dim) @ params["wo"].to(x.dtype)
    return y, cache


def gqa_decode_paged(params: Dict, x: torch.Tensor, cache: Dict, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float, qpos: torch.Tensor,
                     page_table: torch.Tensor,
                     window: Optional[int] = None):
    """One decode tick against a paged KV pool.

    ``cache`` = {k, v, pos[, k_scale, v_scale]} pools (P, pg, ...).  Unlike
    the reference, which returns new pools, this writes the new token's
    K / V and position into ``cache`` IN PLACE and returns it.  Inactive
    (qpos = -1) or unallocated writes land on the reserved trash page 0
    with pos = -1, so they are never attended to.  Returns (y, cache).
    """
    s = x.shape[0]
    pg = cache["k"].shape[1]
    q, k, v = _decode_qkv(params, x, qpos, n_heads, n_kv_heads, head_dim,
                          rope_theta)
    qpos = qpos.long()
    active = qpos >= 0
    qp = torch.clamp_min(qpos, 0)
    phys = page_table.long()[torch.arange(s, device=x.device), qp // pg]
    phys = torch.where(active & (phys >= 0), phys, 0)
    where = (phys, qp % pg)
    cache["pos"][where] = torch.where(active, qpos, -1).to(
        cache["pos"].dtype)
    write_kv(cache, where, k[:, 0], v[:, 0])
    if "k_scale" in cache:
        out = decode_attention_paged_q8(q, cache["k"], cache["v"],
                                        cache["k_scale"], cache["v_scale"],
                                        cache["pos"], page_table, qpos,
                                        window=window)
    else:
        out = decode_attention_paged(q, cache["k"], cache["v"], cache["pos"],
                                     page_table, qpos, window=window)
    y = out.reshape(s, 1, n_heads * head_dim) @ params["wo"].to(x.dtype)
    return y, cache


def _kv_leaves(lead, n_kv_heads: int, head_dim: int, dtype, bits: int,
               device: torch.device) -> Dict:
    """K / V leaves of shape ``lead`` + (KH, hd): in ``dtype``, or for
    bits = 8 int8 codes plus (lead, KH) fp16 absmax scales.  The reference
    stores ``dtype`` for any bits other than 8, and so does this."""
    shape = tuple(lead) + (n_kv_heads, head_dim)
    if bits == 8:
        return dict(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float16,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float16,
                                device=device))
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def init_kv_cache(batch: int, length: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, bits: int = 16,
                  device: DeviceLike = None) -> Dict:
    """Contiguous ring cache (B, L, KH, hd), positions -1 (empty), on
    ``device`` (CUDA unless ``device="cpu"``).  bits = 8: int8 codes plus
    per-(token, kv head) fp16 absmax scales, which fold into the attention
    dots, so no dequantized copy is ever stored."""
    device = resolve_device(device)
    return dict(_kv_leaves((batch, length), n_kv_heads, head_dim, dtype,
                           bits, device),
                pos=torch.full((batch, length), -1, dtype=torch.int32,
                               device=device))


def init_paged_kv_pool(n_pages: int, page_size: int, n_kv_heads: int,
                       head_dim: int, dtype=torch.bfloat16, bits: int = 16,
                       device: DeviceLike = None) -> Dict:
    """(P, pg, ...) pools shared by every request, on ``device`` (CUDA
    unless ``device="cpu"``), bf16 or (bits = 8) int8 as
    ``init_kv_cache``; physical page 0 is the trash page, never handed to
    a request."""
    device = resolve_device(device)
    return dict(_kv_leaves((n_pages, page_size), n_kv_heads, head_dim,
                           dtype, bits, device),
                pos=torch.full((n_pages, page_size), -1, dtype=torch.int32,
                               device=device))


def quantize_kv_token(x: torch.Tensor):
    """(..., KH, hd) -> (int8 codes, fp16 absmax scale over hd).

    The codes are taken with the fp32 scale, before it is rounded to fp16,
    as the reference does; the division by 127 is IEEE on every device
    (``div_exact``: a CUDA tensor over a Python scalar would be a product
    with the reciprocal, which moves some scales by one ulp)."""
    xf = x.float()
    scale = div_exact(xf.abs().amax(dim=-1), 127.0) + 1e-8
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.half()
