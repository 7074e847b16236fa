"""Multi-head Latent Attention, DeepSeek-V2 / MiniCPM3 (port of
``repro/models/layers/mla.py``).

Train / prefill (``mla_forward``) materialise K and V from the compressed
latent and run flash attention with q/k of width qk_nope + qk_rope and v
of width v_head_dim: K1 - K3 at (D, Dv) = (96, 64) for minicpm3_4b.
Decode (``mla_decode``) is the absorbed-weight form: scores and outputs
are computed in the kv_lora latent space in fp32 einsums, against a ring
cache of (kv_lora + qk_rope) values a token, so no decode kernel runs,
as in the reference.  The cache is written IN PLACE, where the reference
returns a new one.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.attention_ref import NEG_INF
from repro_torch.models.layers.attention import flash_attention
from repro_torch.models.layers.norms import rms_norm
from repro_torch.models.layers.rope import apply_rope, rope_angles
from repro_torch.sharding import ctx as shard_ctx


def init_mla_params(n: int, d_model: int, n_heads: int, normal, const, *,
                    q_lora_rank: int, kv_lora_rank: int, qk_nope_dim: int,
                    qk_rope_dim: int, v_head_dim: int) -> Dict:
    """``n`` layer-stacked MLA projections with the reference's leaf names,
    shapes and scales; ``normal(*shape, scale=)`` and ``const(value,
    *shape)`` draw the leaves."""
    qk_dim = qk_nope_dim + qk_rope_dim
    s = d_model ** -0.5
    p = {}
    if q_lora_rank > 0:
        p["wq_a"] = normal(n, d_model, q_lora_rank, scale=s)
        p["q_norm"] = const(1.0, n, q_lora_rank)
        p["wq_b"] = normal(n, q_lora_rank, n_heads * qk_dim,
                           scale=q_lora_rank ** -0.5)
    else:
        p["wq"] = normal(n, d_model, n_heads * qk_dim, scale=s)
    p["wkv_a"] = normal(n, d_model, kv_lora_rank + qk_rope_dim, scale=s)
    p["kv_norm"] = const(1.0, n, kv_lora_rank)
    p["wkv_b"] = normal(n, kv_lora_rank, n_heads * (qk_nope_dim + v_head_dim),
                        scale=kv_lora_rank ** -0.5)
    p["wo"] = normal(n, n_heads * v_head_dim, d_model,
                     scale=(n_heads * v_head_dim) ** -0.5)
    return p


def _project_q(params: Dict, x: torch.Tensor, n_heads: int, qk_nope: int,
               qk_rope: int):
    """(q_nope, q_rope) of (B, S, H, qk_nope / qk_rope)."""
    b, s, _ = x.shape
    if "wq_a" in params:
        ql = rms_norm(x @ params["wq_a"].to(x.dtype), params["q_norm"])
        q = ql @ params["wq_b"].to(x.dtype)
    else:
        q = x @ params["wq"].to(x.dtype)
    q = q.reshape(b, s, n_heads, qk_nope + qk_rope)
    return q[..., :qk_nope], q[..., qk_nope:]


def mla_forward(params: Dict, x: torch.Tensor, *, n_heads: int,
                qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int,
                kv_lora_rank: int, rope_theta: float,
                positions: torch.Tensor, window: Optional[int] = None,
                return_kv: bool = False):
    """Train / prefill with materialised K / V.  Returns y, or with
    ``return_kv`` (y, (c_kv (B, S, kv_lora), k_rope (B, S, qk_rope))),
    the latent cache."""
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(params, x, n_heads, qk_nope_dim, qk_rope_dim)
    kv_a = x @ params["wkv_a"].to(x.dtype)
    c_kv = rms_norm(kv_a[..., :kv_lora_rank], params["kv_norm"])
    k_rope = kv_a[..., kv_lora_rank:].reshape(b, s, 1, qk_rope_dim)
    cos, sin = rope_angles(positions, qk_rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    kv = (c_kv @ params["wkv_b"].to(x.dtype)).reshape(
        b, s, n_heads, qk_nope_dim + v_head_dim)
    k_nope, v = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:]
    k = torch.cat([k_nope, k_rope.expand(b, s, n_heads, qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q, k, v, positions=positions, causal=True,
                          window=window)
    y = out.reshape(b, s, n_heads * v_head_dim) @ params["wo"].to(x.dtype)
    if return_kv:
        return y, (c_kv, k_rope[:, :, 0, :])
    return y


def mla_decode(params: Dict, x: torch.Tensor, cache: Dict, *, n_heads: int,
               qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int,
               kv_lora_rank: int, rope_theta: float, qpos: torch.Tensor,
               window: Optional[int] = None):
    """Absorbed-weight one-token decode against the latent ring cache
    {ckv (B, L, kv_lora), krope (B, L, qk_rope), pos (B, L)}: the new
    token's latent, rotary key and position go to slot qpos mod L IN
    PLACE.  Returns (y, cache)."""
    b = x.shape[0]
    q_nope, q_rope = _project_q(params, x, n_heads, qk_nope_dim, qk_rope_dim)
    cos, sin = rope_angles(qpos[:, None], qk_rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)[:, 0]  # (B, H, dr)
    kv_a = (x @ params["wkv_a"].to(x.dtype))[:, 0]
    c_kv_new = shard_ctx.constrain_latent(
        rms_norm(kv_a[..., :kv_lora_rank], params["kv_norm"]))
    k_rope_new = apply_rope(
        kv_a[..., kv_lora_rank:].reshape(b, 1, 1, qk_rope_dim), cos, sin
    )[:, 0, 0]
    where = (torch.arange(b, device=x.device),
             qpos.long() % cache["ckv"].shape[1])
    cache["ckv"][where] = c_kv_new.to(cache["ckv"].dtype)
    cache["krope"][where] = k_rope_new.to(cache["krope"].dtype)
    cache["pos"][where] = qpos.to(cache["pos"].dtype)

    f32 = torch.float32
    wkv_b = params["wkv_b"].to(x.dtype).reshape(
        kv_lora_rank, n_heads, qk_nope_dim + v_head_dim).to(f32)
    w_uk, w_uv = wkv_b[..., :qk_nope_dim], wkv_b[..., qk_nope_dim:]
    ckv, krope = cache["ckv"].to(f32), cache["krope"].to(f32)
    # absorb: q_lat = q_nope W_uk scores directly against the latent cache
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0].to(f32), w_uk)
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5
    s_all = torch.einsum("bhc,blc->bhl", q_lat, ckv) * scale \
        + torch.einsum("bhd,bld->bhl", q_rope.to(f32), krope) * scale
    kpos = cache["pos"]
    valid = (kpos >= 0) & (kpos <= qpos[:, None])
    if window is not None:
        valid &= qpos[:, None] - kpos < window
    s_all = torch.where(valid[:, None, :], s_all, NEG_INF)
    p = torch.softmax(s_all, dim=-1)
    out_lat = torch.einsum("bhl,blc->bhc", p, ckv)
    out = torch.einsum("bhc,chd->bhd", out_lat, w_uv)
    y = out.reshape(b, 1, n_heads * v_head_dim).to(x.dtype) \
        @ params["wo"].to(x.dtype)
    return y, cache


def init_mla_cache(batch: int, length: int, kv_lora_rank: int,
                   qk_rope_dim: int, dtype=torch.bfloat16,
                   device: DeviceLike = None) -> Dict:
    """The latent ring cache (B, L, ...), positions -1 (empty), on
    ``device`` (CUDA unless ``device="cpu"``)."""
    device = resolve_device(device)
    return dict(
        ckv=torch.zeros((batch, length, kv_lora_rank), dtype=dtype,
                        device=device),
        krope=torch.zeros((batch, length, qk_rope_dim), dtype=dtype,
                          device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device))
