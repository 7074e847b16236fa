"""The decoder stack for the ``dense``, ``moe``, ``mamba2``,
``shared_attn`` and ``rwkv6`` blocks with GQA or MLA attention and the
``text``, ``vlm`` and ``audio`` modalities (port of
``repro/models/transformer.py``: ``init_params``, ``_embed_inputs``,
``init_cmix_params``, ``cmix_forward``, ``block_forward``,
``_fill_kv_cache``, ``_run_segments`` with its remat policies,
``forward``, ``block_decode`` over a ring cache or a paged pool,
``decode_step``, ``decode_step_paged``, ``init_block_cache``,
``init_caches`` and ``init_paged_caches``; 16-bit or int8 KV caches;
MLA's latent ring cache, which, as in the reference, has no paged form
and ignores ``kv_cache_bits``).

Parameters are a plain dict keyed like the reference's tree, with each
segment's layers stacked on a leading axis (``models/stack.py``).  The
compressor (encoder -> RD-FSQ roundtrip with STE -> decoder) runs between
the client and server segment lists.  ``forward`` is differentiable: the
training step (``train/loop.py``) takes its gradient.

Not ported, on purpose: ``utils/barrier.py::grad_safe_barrier``, which the
reference's ``block_forward`` calls.  It keeps XLA from hoisting the
layer-invariant attention masks out of its layer scan; PyTorch runs the
layers eagerly and hoists nothing, so the barrier means nothing here.
A stack holds ``dense`` and ``moe`` blocks (``models/layers/moe.py``),
``mamba2`` blocks (``models/layers/mamba2.py``: ``x + mamba2(rms_norm(x))``)
and uses of Zamba2's ``shared_attn`` block, each segment of one type,
which its functions take as ``block_type`` from
``cfg.client_server_segments()`` as the reference's do: deepseek_v2_236b's
dense first layer (``first_dense_layers``) is a segment of its own before
its moe layers, and zamba2_2_7b alternates runs of mamba2 layers with
single shared blocks.  Each block's auxiliary losses are summed over the
layers, zeros for every block but moe.

The shared block has one set of parameters at the top of the tree,
``params["shared_attn"]`` (no layer axis; its segments are ``{}``), read
by every use: ``xin = concat(x, emb0) @ w_in``, then a dense block on
``xin``, then ``x + out``.  ``emb0`` is the embedded input (the prompt's in
``forward``, the token's in ``_decode``), handed to the server's shared
blocks directly, not over the wire, as the reference does.  A use runs
outside ``run_stack``, with no remat, and its ring cache carries a leading
axis of 1.  A mamba2 layer's decode cache is {state, conv}; the paged
engine refuses mamba2 blocks, as the reference's does.

An ``rwkv6`` block (rwkv6_7b) is ``x + tmix(rms_norm(x))`` then ``x +
cmix(rms_norm(x))``: the time mix of ``models/layers/rwkv6.py`` and the
channel mix here (relu^2 of a ``d_ff`` expansion under a sigmoid gate),
each with its token shift (the previous position's input, zeros before
the first).  Its decode cache is {tmix: {state, x_last}, cmix_last}; no
attention body runs in it, and the paged pools refuse it, as the
reference's do.  The ``audio`` modality (musicgen_large) embeds a (B, K,
S) code grid through one table a codebook, summed, and its head gives
(B, S, K, V) logits (``models/layers/embedding.py``); a decode step
takes ``codes`` (B, K, 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import split as split_mod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import stack as stack_mod
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import mamba2 as mamba_mod
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import rwkv6 as rwkv_mod
from repro_torch.models.layers.embedding import (embed, embed_codebooks,
                                                 head_logits)
from repro_torch.models.layers.mlp import mlp_forward, swiglu_forward
from repro_torch.models.layers.norms import rms_norm
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.utils.tree import tree_map

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


BLOCK_TYPES = ("dense", "moe", "mamba2", "shared_attn", "rwkv6")


def _check_supported(cfg: ArchConfig) -> None:
    """What the reference refuses: a block type its ``init_block_params``
    does not know raises ``ValueError`` naming it."""
    for t in cfg.block_pattern():
        if t not in BLOCK_TYPES:
            raise ValueError(t)


# ---------------------------------------------------------------------------
# the RWKV channel mix (the FFN half of an rwkv6 block)
# ---------------------------------------------------------------------------

def init_cmix_params(n: int, d_model: int, d_ff: int, normal, const
                     ) -> Dict:
    """``n`` layer-stacked channel mixes with the reference's shapes and
    scales."""
    return dict(
        mu_k=const(0.5, n, d_model),
        mu_r=const(0.5, n, d_model),
        wk=normal(n, d_model, d_ff, scale=d_model ** -0.5),
        wv=normal(n, d_ff, d_model, scale=d_ff ** -0.5),
        wr=normal(n, d_model, d_model, scale=d_model ** -0.5),
    )


def cmix_forward(p: Dict, x: torch.Tensor, x_prev: torch.Tensor
                 ) -> torch.Tensor:
    """sigmoid(xr @ wr) * (relu(xk @ wk)^2 @ wv), xk and xr the token
    shifts of x toward ``x_prev``."""
    dt = x.dtype
    xk = x + (x_prev - x) * p["mu_k"].to(dt)
    xr = x + (x_prev - x) * p["mu_r"].to(dt)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    return torch.sigmoid(xr @ p["wr"].to(dt)) * (k @ p["wv"].to(dt))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block_params(cfg: ArchConfig, n: int, normal, const, *,
                      block_type: str = "dense",
                      gen: Optional[torch.Generator] = None) -> Dict:
    """``n`` layer-stacked blocks of ``block_type``: ``dense`` (a SwiGLU of
    width ``d_ff``), ``moe`` (experts of width ``moe_d_ff``, shared
    experts, a dense residual), ``mamba2`` (``ln`` and the mixer; ``gen``,
    ``leaf_makers``' generator, draws its dt), ``shared_attn`` (a dense
    block with its 2d -> d input projection ``w_in``) or ``rwkv6`` (``ln1``,
    ``ln2``, the time mix ``tmix`` and the channel mix ``cmix``).
    ``normal(*shape, scale=)`` and ``const(value, *shape)`` draw the leaves
    (a moe block's router and experts pass ``normal`` the ``dtype`` and
    ``per_expert`` keywords of ``leaf_makers``)."""
    d, hd = cfg.d_model, cfg.head_dim
    if block_type == "mamba2":
        return {"ln": const(1.0, n, d),
                "mixer": mamba_mod.init_mamba2_params(
                    n, d, normal, const, gen, **_ssm_kwargs(cfg))}
    if block_type == "rwkv6":
        return {"ln1": const(1.0, n, d), "ln2": const(1.0, n, d),
                "tmix": rwkv_mod.init_rwkv6_params(
                    n, d, normal, const, head_dim=cfg.rwkv_head_dim),
                "cmix": init_cmix_params(n, d, cfg.d_ff, normal, const)}
    dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    if cfg.attn_type == "mla":
        attn = mla_mod.init_mla_params(
            n, d, cfg.n_heads, normal, const, q_lora_rank=cfg.q_lora_rank,
            kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
            qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim)
    else:
        attn = {
            "wq": normal(n, d, dq, scale=d ** -0.5),
            "wk": normal(n, d, dkv, scale=d ** -0.5),
            "wv": normal(n, d, dkv, scale=d ** -0.5),
            "wo": normal(n, dq, d, scale=dq ** -0.5),
        }
    if block_type == "moe":
        ffn = moe_mod.init_moe_params(
            n, d, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff, normal, const,
            n_shared_experts=cfg.n_shared_experts,
            dense_residual_d_ff=cfg.d_ff if cfg.dense_residual else 0)
    else:
        ffn = {
            "w_gate": normal(n, d, cfg.d_ff, scale=d ** -0.5),
            "w_up": normal(n, d, cfg.d_ff, scale=d ** -0.5),
            "w_down": normal(n, cfg.d_ff, d, scale=cfg.d_ff ** -0.5),
        }
    block = {
        "ln1": const(1.0, n, d),
        "ln2": const(1.0, n, d),
        "attn": attn,
        "ffn": ffn,
    }
    if block_type == "shared_attn":
        block = {"w_in": normal(n, 2 * d, d, scale=(2 * d) ** -0.5),
                 **block}
    return block


def _ssm_kwargs(cfg: ArchConfig) -> Dict:
    return dict(expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                d_state=cfg.ssm_state)


def leaf_makers(cfg: ArchConfig, seed: int, device: DeviceLike):
    """``(normal, const, gen, dev)``: leaf makers in the parameter dtype
    drawing from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    param_dtype = pdtype(cfg)

    def draw(shape, scale, dt):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)  # the same bits as (x * scale)

    def normal(*shape, scale, dtype=None, per_expert=False):
        """A leaf in ``dtype`` (the parameter dtype by default); with
        ``per_expert`` a (layers, experts, ...) stack drawn one expert at a
        time into the leaf, so a stack of 8.9 G elements never exists in
        fp32."""
        dt = dtype or param_dtype
        if not per_expert:
            return draw(shape, scale, dt)
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            for j in range(shape[1]):
                out[i, j] = draw(shape[2:], scale, dt)
        return out

    def const(value, *shape):
        return torch.full(shape, value, dtype=param_dtype, device=dev)

    return normal, const, gen, dev


def init_connector_params(cfg: ArchConfig, normal, const) -> Dict:
    """The vision -> language connector, a 2-layer GELU MLP (d_vision ->
    d_connector -> d_model)."""
    d = cfg.d_model
    d_conn = cfg.d_connector or d
    return {
        "w1": normal(cfg.d_vision, d_conn, scale=cfg.d_vision ** -0.5),
        "b1": const(0.0, d_conn),
        "w2": normal(d_conn, d, scale=d_conn ** -0.5),
        "b2": const(0.0, d),
    }


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the reference's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA
    unless ``device="cpu"``).  The draws differ from the reference's
    ``jax.random`` ones; tests carry the reference's own parameters
    across with ``repro_torch.bridge.from_jax_params``.  A text model has
    no connector; an audio model has a (K, V, d) embedding, one table a
    codebook, and a (K, d, V) head."""
    _check_supported(cfg)
    normal, const, gen, dev = leaf_makers(cfg, seed, device)
    dtype = pdtype(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    books = (cfg.n_codebooks,) if cfg.modality == "audio" else ()
    params: Dict = {"embed": {"emb": normal(*books, v, d, scale=0.02)}}
    if cfg.modality == "vlm":
        params["connector"] = init_connector_params(cfg, normal, const)
    params["head"] = {"w": normal(*books, d, v, scale=d ** -0.5)}
    params["final_norm"] = const(1.0, d)
    if "shared_attn" in cfg.block_pattern():  # one block, no layer axis
        params["shared_attn"] = tree_map(
            lambda t: t[0].clone(), init_block_params(
                cfg, 1, normal, const, block_type="shared_attn"))
    client_segs, server_segs = cfg.client_server_segments()
    for side, segs in (("client", client_segs), ("server", server_segs)):
        params[side] = {
            f"seg{i}": {} if t == "shared_attn" else init_block_params(
                cfg, n, normal, const, block_type=t, gen=gen)
            for i, (t, n) in enumerate(segs)}
    if cfg.split.enabled and cfg.split.learnable_codec:
        # near-identity, so the cut is transparent at step 0
        eye = torch.eye(d, dtype=torch.float32, device=dev)
        noise = 0.01 / d ** 0.5
        params["codec"] = {
            "enc_w": (eye + noise * torch.randn(
                (d, d), generator=gen, device=dev)).to(dtype),
            "enc_b": const(0.0, d),
            "dec_w": (eye + noise * torch.randn(
                (d, d), generator=gen, device=dev)).to(dtype),
            "dec_b": const(0.0, d),
        }
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_kwargs(cfg: ArchConfig) -> Dict:
    if cfg.attn_type == "mla":
        return dict(n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim,
                    qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                    kv_lora_rank=cfg.kv_lora_rank, rope_theta=cfg.rope_theta)
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _attn_forward(cfg: ArchConfig, p: Dict, h: torch.Tensor, positions,
                  window, return_kv: bool = False):
    fwd = mla_mod.mla_forward if cfg.attn_type == "mla" \
        else attn_mod.gqa_forward
    return fwd(p, h, positions=positions, window=window,
               return_kv=return_kv, **_attn_kwargs(cfg))


def _fill_kv_cache(cfg: ArchConfig, kv, cache_len: int,
                   positions: torch.Tensor) -> Dict:
    """Place prefill K/V (MLA: the latent and the rotary key) into a ring
    buffer of ``cache_len`` slots."""
    keep = min(kv[0].shape[1], cache_len)
    pos = positions[-keep:]
    where = (slice(None), (pos % cache_len).long())
    if cfg.attn_type == "mla":
        ckv, krope = kv  # (B, S, kv_lora), (B, S, dr)
        b = ckv.shape[0]
        cache = mla_mod.init_mla_cache(b, cache_len, cfg.kv_lora_rank,
                                       cfg.qk_rope_dim, dtype=ckv.dtype,
                                       device=ckv.device)
        cache["ckv"][where] = ckv[:, -keep:]
        cache["krope"][where] = krope[:, -keep:]
        cache["pos"][where] = pos.to(torch.int32).expand(b, keep)
        return cache
    k, v = kv  # (B, S, KH, hd)
    b = k.shape[0]
    cache = attn_mod.init_kv_cache(b, cache_len, cfg.n_kv_heads,
                                   cfg.head_dim, dtype=k.dtype,
                                   bits=cfg.kv_cache_bits, device=k.device)
    attn_mod.write_kv(cache, where, k[:, -keep:], v[:, -keep:])
    cache["pos"][where] = pos.to(torch.int32).expand(b, keep)
    return cache


AUX_KEYS = ("load_balance", "router_z", "drop_fraction")


def _empty_aux(device) -> Dict[str, torch.Tensor]:
    """The MoE auxiliaries of a dense block: all zero."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _ffn(cfg: ArchConfig, block_type: str, p: Dict, h: torch.Tensor,
         capacity_factor: float):
    """The block's feed-forward: SwiGLU, or for a ``moe`` block the MoE
    layer at ``capacity_factor``.  Returns (out, aux or None)."""
    if block_type == "moe":
        return moe_mod.moe_forward(p, h, top_k=cfg.moe_top_k,
                                   capacity_factor=capacity_factor)
    return swiglu_forward(p, h), None


def _shared_in(block_type: str, p: Dict, x: torch.Tensor,
               emb0: Optional[torch.Tensor]) -> torch.Tensor:
    """The input of a block's attention half: x, or for a ``shared_attn``
    block concat(x, emb0) through its 2d -> d projection."""
    if block_type != "shared_attn":
        return x
    return torch.cat([x, emb0], dim=-1) @ p["w_in"].to(x.dtype)


def block_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                  positions: torch.Tensor, window: Optional[int],
                  collect_cache: Optional[int] = None,
                  block_type: str = "dense",
                  emb0: Optional[torch.Tensor] = None):
    """Full-sequence block of ``block_type``: ``dense``, ``moe`` (the MoE
    layer at the config's capacity factor; its auxiliaries in fp32, zeros
    for every other block), ``mamba2`` (its cache {state, conv}),
    ``shared_attn`` (reading ``emb0``, the embedded input) or ``rwkv6``
    (its cache {tmix: {state, x_last}, cmix_last}).  Returns (x, aux,
    cache_or_None)."""
    aux = _empty_aux(x.device)
    if block_type == "rwkv6":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        tcache = None
        if collect_cache is None:
            y = rwkv_mod.rwkv6_forward(p["tmix"], h,
                                       head_dim=cfg.rwkv_head_dim)
        else:
            y, tcache = rwkv_mod.rwkv6_forward(
                p["tmix"], h, head_dim=cfg.rwkv_head_dim, return_state=True)
        x = x + y
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        h2_prev = torch.nn.functional.pad(h2, (0, 0, 1, 0))[:, :-1]
        x = x + cmix_forward(p["cmix"], h2, h2_prev)
        cache = None if collect_cache is None \
            else dict(tmix=tcache, cmix_last=h2[:, -1:])
        return shard_ctx.constrain(x, "hidden"), aux, cache
    if block_type == "mamba2":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if collect_cache is None:
            y, cache = mamba_mod.mamba2_forward(p["mixer"], h,
                                                **_ssm_kwargs(cfg)), None
        else:
            y, cache = mamba_mod.mamba2_forward(
                p["mixer"], h, return_state=True, **_ssm_kwargs(cfg))
        return shard_ctx.constrain(x + y, "hidden"), aux, cache
    xin = _shared_in(block_type, p, x, emb0)
    h = rms_norm(xin, p["ln1"], cfg.norm_eps)
    cache = None
    if collect_cache is not None:
        a, kv = _attn_forward(cfg, p["attn"], h, positions, window,
                              return_kv=True)
        cache = _fill_kv_cache(cfg, kv, collect_cache, positions)
    else:
        a = _attn_forward(cfg, p["attn"], h, positions, window)
    xin = xin + a
    h2 = rms_norm(xin, p["ln2"], cfg.norm_eps)
    f, moe_aux = _ffn(cfg, block_type, p["ffn"], h2, cfg.capacity_factor)
    if moe_aux is not None:
        aux.update({k: v.float() for k, v in moe_aux.items()})
    out = xin + f
    if block_type == "shared_attn":
        out = x + out  # a residual around the whole shared block
    return shard_ctx.constrain(out, "hidden"), aux, cache


def block_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor, cache: Dict, *,
                 qpos: torch.Tensor, window: Optional[int],
                 page_table: Optional[torch.Tensor] = None,
                 block_type: str = "dense",
                 emb0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token block of ``block_type``: ``dense``, ``moe`` (the MoE
    layer at capacity factor 8: no drops at decode, as in the reference),
    ``mamba2`` (the recurrence on its {state, conv} cache),
    ``shared_attn`` (reading ``emb0``, the token's embedding) or ``rwkv6``
    (the recurrence on {tmix: {state, x_last}, cmix_last}); ``cache``
    (this layer's ring cache, or with ``page_table`` its (P, pg, ...)
    pools, the batch axis of ``x`` then being the scheduler's slot axis)
    is updated in place.  Returns x."""
    if block_type == "mamba2":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y, new = mamba_mod.mamba2_decode(p["mixer"], h, cache,
                                         **_ssm_kwargs(cfg))
        for k, v in new.items():
            cache[k].copy_(v)
        return x + y
    if block_type == "rwkv6":
        if page_table is not None:
            raise NotImplementedError(
                "paged serving does not support rwkv6 blocks")
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, tnew = rwkv_mod.rwkv6_decode(p["tmix"], h, cache["tmix"],
                                        head_dim=cfg.rwkv_head_dim)
        x = x + y
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + cmix_forward(p["cmix"], h2, cache["cmix_last"].to(h2.dtype))
        for k, v in tnew.items():
            cache["tmix"][k].copy_(v)
        cache["cmix_last"].copy_(h2)
        return x
    xin = _shared_in(block_type, p, x, emb0)
    h = rms_norm(xin, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        if page_table is not None:
            raise NotImplementedError("paged decode requires GQA KV caches "
                                      "(attn_type != mla)")
        a, _ = mla_mod.mla_decode(p["attn"], h, cache, qpos=qpos,
                                  window=window, **_attn_kwargs(cfg))
    elif page_table is None:
        a, _ = attn_mod.gqa_decode(p["attn"], h, cache, qpos=qpos,
                                   window=window, **_attn_kwargs(cfg))
    else:
        a, _ = attn_mod.gqa_decode_paged(p["attn"], h, cache, qpos=qpos,
                                         page_table=page_table,
                                         window=window, **_attn_kwargs(cfg))
    xin = xin + a
    h2 = rms_norm(xin, p["ln2"], cfg.norm_eps)
    out = xin + _ffn(cfg, block_type, p["ffn"], h2, 8.0)[0]
    return x + out if block_type == "shared_attn" else out


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _stacked(cfg: ArchConfig, make_one) -> Dict:
    """One cache per layer, stacked per segment and keyed like the
    parameters (a shared block's use: a stack of one); ``make_one(t)``
    builds a layer's cache for block type t."""
    out = {}
    for side, segs in zip(("client", "server"),
                          cfg.client_server_segments()):
        out[side] = {}
        for i, (t, n) in enumerate(segs):
            out[side][f"seg{i}"] = tree_map(
                lambda v, n=n: v.unsqueeze(0).repeat((n,) + (1,) * v.ndim),
                make_one(t))
    return out


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     dtype=torch.bfloat16, device: DeviceLike = None, *,
                     block_type: str = "dense") -> Dict:
    """One block's decode cache on ``device`` (CUDA unless
    ``device="cpu"``): an attention block's ring cache (B, cache_len, ...),
    16-bit or int8 as ``cfg.kv_cache_bits`` says (MLA: the latent cache in
    ``dtype``); a ``mamba2`` block's {state fp32, conv in ``dtype``}; an
    ``rwkv6`` block's {tmix: {state fp32, x_last}, cmix_last}, the last
    two (B, 1, d) in ``dtype``."""
    _check_supported(cfg)
    if block_type == "mamba2":
        return mamba_mod.init_mamba2_cache(batch, cfg.d_model, dtype=dtype,
                                           device=device, **_ssm_kwargs(cfg))
    if block_type == "rwkv6":
        return dict(
            tmix=rwkv_mod.init_rwkv6_cache(batch, cfg.d_model,
                                           cfg.rwkv_head_dim, dtype,
                                           device=device),
            cmix_last=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                  device=resolve_device(device)))
    if cfg.attn_type == "mla":
        return mla_mod.init_mla_cache(batch, cache_len, cfg.kv_lora_rank,
                                      cfg.qk_rope_dim, dtype, device=device)
    return attn_mod.init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                                  cfg.head_dim, dtype,
                                  bits=cfg.kv_cache_bits, device=device)


def init_caches(cfg: ArchConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device: DeviceLike = None) -> Dict:
    """Stacked ring caches per segment, keyed like the parameters, on
    ``device`` (CUDA unless ``device="cpu"``)."""
    device = resolve_device(device)
    return _stacked(cfg, lambda t: init_block_cache(
        cfg, batch, cache_len, dtype, device, block_type=t))


def init_paged_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                      dtype=torch.bfloat16, device: DeviceLike = None
                      ) -> Dict:
    """Stacked paged KV pools per segment, keyed like the parameters: one
    (P, pg, ...) pool per layer, shared page table across layers, on
    ``device`` (CUDA unless ``device="cpu"``).  MLA, mamba2 and rwkv6
    blocks have no paged form and raise, as in the reference."""
    _check_supported(cfg)
    if cfg.attn_type == "mla":
        raise NotImplementedError("paged serving requires GQA KV caches")
    device = resolve_device(device)

    def pool(t):
        if t in ("mamba2", "rwkv6"):
            raise NotImplementedError(
                f"paged serving does not support {t} blocks")
        return attn_mod.init_paged_kv_pool(
            n_pages, page_size, cfg.n_kv_heads, cfg.head_dim, dtype,
            bits=cfg.kv_cache_bits, device=device)

    return _stacked(cfg, pool)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _embed_inputs(params: Dict, cfg: ArchConfig, batch: Dict
                  ) -> torch.Tensor:
    dtype = cdtype(cfg)
    if cfg.modality == "audio":
        return embed_codebooks(params["embed"], batch["codes"], dtype)
    if cfg.modality != "vlm":
        return embed(params["embed"], batch["tokens"], dtype)
    if "image_features" in batch:
        # split-serve: the client ran the connector and shipped its
        # activations over the quantized wire; embed them as they are
        img = batch["image_features"].to(dtype)
    else:
        img = mlp_forward(params["connector"],
                          batch["image_embeds"].to(dtype))
    tok = embed(params["embed"], batch["tokens"], dtype)
    return torch.cat([img, tok], dim=1)


def _remat_group(cfg: ArchConfig, n: int, x: torch.Tensor) -> int:
    """``cfg.remat_group``, or when unset the bytes-aware auto-tuner's
    choice from the carry entering the segment (the stored layer input of
    the remat schedule), as the reference decides it."""
    if cfg.remat and cfg.remat_group == 0:
        return stack_mod.auto_group_size(n, x.numel() * x.element_size())
    return cfg.remat_group


def _run_segments(params: Dict, cfg: ArchConfig, side: str, segs, x, *,
                  positions, window, emb0: torch.Tensor,
                  collect_cache: Optional[int] = None):
    """Run one side's segments; a shared block's use runs once on
    ``params["shared_attn"]``, outside the stack executor and so with no
    remat, as in the reference.  Returns (x, aux_sum, caches)."""
    aux_sum = _empty_aux(x.device)
    caches = {}
    for i, (t, _) in enumerate(segs):
        if t == "shared_attn":
            x, aux, cache = block_forward(
                cfg, params["shared_attn"], x, positions=positions,
                window=window, collect_cache=collect_cache, block_type=t,
                emb0=emb0)
            aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
            if collect_cache is not None:
                caches[f"seg{i}"] = {k: v.unsqueeze(0)
                                     for k, v in cache.items()}
            continue

        def body(carry, p, t=t):
            y, aux, cache = block_forward(cfg, p, carry, positions=positions,
                                          window=window,
                                          collect_cache=collect_cache,
                                          block_type=t, emb0=emb0)
            return y, (aux, cache)

        stacked = params[side][f"seg{i}"]
        x, seg_aux, seg_caches = stack_mod.run_stack(
            body, x, stacked, remat=cfg.remat,
            remat_group=_remat_group(cfg, stack_mod.stack_len(stacked), x),
            collect=collect_cache is not None)
        aux_sum = {k: aux_sum[k] + seg_aux[k] for k in aux_sum}
        if collect_cache is not None:
            caches[f"seg{i}"] = seg_caches
    return x, aux_sum, caches


def layer_forward_count(cfg: ArchConfig, x: torch.Tensor) -> int:
    """How many times one training step's forward + backward runs an
    attention block's body (and so K1), summed over every segment, for the
    remat policy ``_run_segments`` picks for a carry like ``x`` (B, S, d):
    a shared block's use once (no remat), a mamba2 or rwkv6 layer never."""
    total = 0
    for segs in cfg.client_server_segments():
        for t, n in segs:
            if t == "shared_attn":
                total += 1
            elif t not in ("mamba2", "rwkv6"):
                total += stack_mod.layer_forward_count(
                    n, cfg.remat, _remat_group(cfg, n, x))
    return total


def forward(params: Dict, cfg: ArchConfig, batch: Dict, *,
            rng: Optional[torch.Generator] = None,
            window: Optional[int] = None,
            collect_cache: Optional[int] = None):
    """Full-sequence forward (train / prefill).

    Returns (logits, aux) or (logits, aux, caches) when ``collect_cache``
    (a cache length) is given; aux = {commit, load_balance, router_z,
    drop_fraction}.  ``rng`` is handed to the compressor (a
    ``torch.Generator`` for Top-K's random picks; the others draw none).
    """
    _check_supported(cfg)
    x = shard_ctx.constrain(_embed_inputs(params, cfg, batch), "hidden")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    positions = positions.to(torch.int32)
    emb0 = x  # the shared blocks' second input, on both sides of the cut
    client_segs, server_segs = cfg.client_server_segments()
    x, aux_c, caches_c = _run_segments(
        params, cfg, "client", client_segs, x, positions=positions,
        window=window, emb0=emb0, collect_cache=collect_cache)
    # the paper's compressor at the cut
    x, commit = split_mod.compressor_roundtrip(params.get("codec"),
                                               cfg.split, x, rng)
    x, aux_s, caches_s = _run_segments(
        params, cfg, "server", server_segs, x, positions=positions,
        window=window, emb0=emb0, collect_cache=collect_cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params["head"], x)
    if logits.ndim == 3:
        logits = shard_ctx.constrain(logits, "logits")
    aux = {k: aux_c[k] + aux_s[k] for k in aux_c}
    aux["commit"] = commit
    if collect_cache is not None:
        return logits, aux, dict(client=caches_c, server=caches_s)
    return logits, aux


def _decode(params: Dict, cfg: ArchConfig, caches: Dict, batch: Dict,
            qpos: torch.Tensor, window: Optional[int],
            page_table: Optional[torch.Tensor]) -> torch.Tensor:
    """One token (audio: one frame of ``codes`` (B, K, 1)) through every
    layer and the compressor at the cut; the caches (ring, or paged with
    ``page_table``) are updated in place.  Returns the logits."""
    if cfg.modality == "audio":
        x = embed_codebooks(params["embed"], batch["codes"], cdtype(cfg))
    else:
        x = embed(params["embed"], batch["tokens"], cdtype(cfg))
    emb0 = x
    client_segs, server_segs = cfg.client_server_segments()

    def run_side(side, segs, x):
        for i, (t, _) in enumerate(segs):
            cache = caches[side][f"seg{i}"]
            if t == "shared_attn":  # its one-layer cache
                x = block_decode(cfg, params["shared_attn"], x,
                                 stack_mod.tree_index(cache, 0), qpos=qpos,
                                 window=window, page_table=page_table,
                                 block_type=t, emb0=emb0)
                continue

            def body(carry, pc, t=t):
                p, c = pc
                return block_decode(cfg, p, carry, c, qpos=qpos,
                                    window=window, page_table=page_table,
                                    block_type=t, emb0=emb0)

            x, _ = stack_mod.run_decode_stack(
                body, x, params[side][f"seg{i}"], cache)
        return x

    x = run_side("client", client_segs, x)
    x, _ = split_mod.compressor_roundtrip(params.get("codec"), cfg.split, x)
    x = run_side("server", server_segs, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(params["head"], x)


def decode_step(params: Dict, cfg: ArchConfig, caches: Dict, batch: Dict,
                qpos: torch.Tensor, *, window: Optional[int] = None):
    """One-token serve step against the ring caches.

    batch: {tokens: (B, 1)} (the images were consumed at prefill), or
    for an audio config {codes: (B, K, 1)}; qpos
    (B,) absolute positions.  The caches are updated in place (the
    reference donates them).  Returns (logits, caches).
    """
    return _decode(params, cfg, caches, batch, qpos, window, None), caches


def decode_step_paged(params: Dict, cfg: ArchConfig, pools: Dict,
                      batch: Dict, qpos: torch.Tensor,
                      page_table: torch.Tensor, *,
                      window: Optional[int] = None):
    """One decode tick of the serving engine against the paged pools.

    ``page_table`` (S, npp) int32, -1 unallocated; ``qpos`` (S,), -1 for
    an inactive slot (its logits are garbage and its KV write lands on the
    trash page).  The pools are updated in place.  Returns (logits,
    pools).
    """
    return _decode(params, cfg, pools, batch, qpos, window,
                   page_table), pools
