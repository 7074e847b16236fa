"""The decoder stack for the ``dense`` block and the ``vlm`` modality (port
of ``repro/models/transformer.py``: ``init_params``, ``_embed_inputs``,
``block_forward``, ``_fill_kv_cache``, ``_run_segments`` with its remat
policies, ``forward``, the paged branch of ``block_decode``,
``decode_step_paged`` and ``init_paged_caches``).

Parameters are a plain dict keyed like the reference's tree, with each
segment's layers stacked on a leading axis (``models/stack.py``).  The
compressor (encoder -> RD-FSQ roundtrip with STE -> decoder) runs between
the client and server segment lists.  ``forward`` is differentiable: the
training step (``train/loop.py``) takes its gradient.

Not ported, on purpose: ``utils/barrier.py::grad_safe_barrier``, which the
reference's ``block_forward`` calls.  It keeps XLA from hoisting the
layer-invariant attention masks out of its layer scan; PyTorch runs the
layers eagerly and hoists nothing, so the barrier means nothing here.
The MoE auxiliary losses are carried as zeros, which is what dense blocks
give; the other block types and modalities are ROADMAP item M11.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import split as split_mod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import stack as stack_mod
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers.embedding import embed, head_logits
from repro_torch.models.layers.mlp import mlp_forward, swiglu_forward
from repro_torch.models.layers.norms import rms_norm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.modality != "vlm" or cfg.attn_type != "gqa" \
            or set(cfg.block_pattern()) != {"dense"}:
        raise NotImplementedError(
            f"{cfg.name}: this slice ports dense GQA blocks with the vlm "
            "modality; the rest is ROADMAP queue M, item M11")
    if cfg.kv_cache_bits != 16:
        raise NotImplementedError(
            "the int8 KV cache is the K7/K9 slice (ROADMAP queue K)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the reference's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA
    unless ``device="cpu"``).  The draws differ from the reference's
    ``jax.random`` ones; tests carry the reference's own parameters
    across with ``repro_torch.bridge.from_jax_params``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = pdtype(cfg)

    def normal(*shape, scale):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=dev)

    d, hd = cfg.d_model, cfg.head_dim
    dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    d_conn = cfg.d_connector or d
    params: Dict = {
        "embed": {"emb": normal(cfg.vocab_size, d, scale=0.02)},
        "connector": {
            "w1": normal(cfg.d_vision, d_conn, scale=cfg.d_vision ** -0.5),
            "b1": const(0.0, d_conn),
            "w2": normal(d_conn, d, scale=d_conn ** -0.5),
            "b2": const(0.0, d),
        },
        "head": {"w": normal(d, cfg.vocab_size, scale=d ** -0.5)},
        "final_norm": const(1.0, d),
    }
    client_segs, server_segs = cfg.client_server_segments()
    for side, segs in (("client", client_segs), ("server", server_segs)):
        params[side] = {
            f"seg{i}": {
                "ln1": const(1.0, n, d),
                "ln2": const(1.0, n, d),
                "attn": {
                    "wq": normal(n, d, dq, scale=d ** -0.5),
                    "wk": normal(n, d, dkv, scale=d ** -0.5),
                    "wv": normal(n, d, dkv, scale=d ** -0.5),
                    "wo": normal(n, dq, d, scale=dq ** -0.5),
                },
                "ffn": {
                    "w_gate": normal(n, d, cfg.d_ff, scale=d ** -0.5),
                    "w_up": normal(n, d, cfg.d_ff, scale=d ** -0.5),
                    "w_down": normal(n, cfg.d_ff, d,
                                     scale=cfg.d_ff ** -0.5),
                },
            } for i, (_, n) in enumerate(segs)}
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
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _fill_kv_cache(cfg: ArchConfig, kv, cache_len: int,
                   positions: torch.Tensor) -> Dict:
    """Place prefill K/V into a ring buffer of ``cache_len`` slots."""
    k, v = kv  # (B, S, KH, hd)
    b, s = k.shape[:2]
    cache = attn_mod.init_kv_cache(b, cache_len, cfg.n_kv_heads,
                                   cfg.head_dim, dtype=k.dtype,
                                   bits=cfg.kv_cache_bits, device=k.device)
    keep = min(s, cache_len)
    pos = positions[-keep:]
    slots = (pos % cache_len).long()
    cache["k"][:, slots] = k[:, -keep:]
    cache["v"][:, slots] = v[:, -keep:]
    cache["pos"][:, slots] = pos.to(torch.int32).expand(b, keep)
    return cache


AUX_KEYS = ("load_balance", "router_z", "drop_fraction")


def _empty_aux(device) -> Dict[str, torch.Tensor]:
    """The MoE auxiliaries of a dense block: all zero."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def block_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                  positions: torch.Tensor, window: Optional[int],
                  collect_cache: Optional[int] = None):
    """Full-sequence dense block.  Returns (x, aux, cache_or_None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = None
    if collect_cache is not None:
        a, kv = attn_mod.gqa_forward(p["attn"], h, positions=positions,
                                     window=window, return_kv=True,
                                     **_attn_kwargs(cfg))
        cache = _fill_kv_cache(cfg, kv, collect_cache, positions)
    else:
        a = attn_mod.gqa_forward(p["attn"], h, positions=positions,
                                 window=window, **_attn_kwargs(cfg))
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu_forward(p["ffn"], h2), _empty_aux(x.device), cache


def block_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor, cache: Dict, *,
                 qpos: torch.Tensor, page_table: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """One-token dense block over the paged pool; ``cache`` (this layer's
    (P, pg, ...) pools) is updated in place.  Returns x."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn_mod.gqa_decode_paged(p["attn"], h, cache, qpos=qpos,
                                     page_table=page_table, window=window,
                                     **_attn_kwargs(cfg))
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu_forward(p["ffn"], h2)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_paged_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                      dtype=torch.bfloat16, device: DeviceLike = None
                      ) -> Dict:
    """Stacked paged KV pools per segment, keyed like the parameters: one
    (P, pg, ...) pool per layer, shared page table across layers, on
    ``device`` (CUDA unless ``device="cpu"``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    client_segs, server_segs = cfg.client_server_segments()
    out = {}
    for side, segs in (("client", client_segs), ("server", server_segs)):
        out[side] = {}
        for i, (_, n) in enumerate(segs):
            one = attn_mod.init_paged_kv_pool(
                n_pages, page_size, cfg.n_kv_heads, cfg.head_dim, dtype,
                bits=cfg.kv_cache_bits, device=device)
            out[side][f"seg{i}"] = {
                k: v.unsqueeze(0).repeat((n,) + (1,) * v.ndim)
                for k, v in one.items()}
    return out


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _embed_inputs(params: Dict, cfg: ArchConfig, batch: Dict
                  ) -> torch.Tensor:
    dtype = cdtype(cfg)
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
                  positions, window, collect_cache: Optional[int] = None):
    """Run one side's segments.  Returns (x, aux_sum, caches)."""
    aux_sum = _empty_aux(x.device)
    caches = {}
    for i, _ in enumerate(segs):
        def body(carry, p):
            y, aux, cache = block_forward(cfg, p, carry, positions=positions,
                                          window=window,
                                          collect_cache=collect_cache)
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
    """How many times one training step's forward + backward runs a layer
    body (and so K1), summed over every segment, for the remat policy
    ``_run_segments`` picks for a carry like ``x`` (B, S, d)."""
    total = 0
    for segs in cfg.client_server_segments():
        for _, n in segs:
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
    drop_fraction}.  ``rng`` is the reference's argument, handed to the
    compressor; RD-FSQ draws no randomness.
    """
    _check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    positions = positions.to(torch.int32)
    client_segs, server_segs = cfg.client_server_segments()
    x, aux_c, caches_c = _run_segments(
        params, cfg, "client", client_segs, x, positions=positions,
        window=window, collect_cache=collect_cache)
    # the paper's compressor at the cut
    x, commit = split_mod.compressor_roundtrip(params.get("codec"),
                                               cfg.split, x, rng)
    x, aux_s, caches_s = _run_segments(
        params, cfg, "server", server_segs, x, positions=positions,
        window=window, collect_cache=collect_cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params["head"], x)
    aux = {k: aux_c[k] + aux_s[k] for k in aux_c}
    aux["commit"] = commit
    if collect_cache is not None:
        return logits, aux, dict(client=caches_c, server=caches_s)
    return logits, aux


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
    x = embed(params["embed"], batch["tokens"], cdtype(cfg))
    client_segs, server_segs = cfg.client_server_segments()

    def run_side(side, segs, x):
        for i, _ in enumerate(segs):
            def body(carry, pc):
                p, c = pc
                return block_decode(cfg, p, carry, c, qpos=qpos,
                                    page_table=page_table, window=window)

            x, _ = stack_mod.run_decode_stack(
                body, x, params[side][f"seg{i}"], pools[side][f"seg{i}"])
        return x

    x = run_side("client", client_segs, x)
    x, _ = split_mod.compressor_roundtrip(params.get("codec"), cfg.split, x)
    x = run_side("server", server_segs, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(params["head"], x), pools
