"""ArchConfig: one declarative description per architecture (port of
``repro/configs/base.py``).

Field for field and default for default the reference's dataclass, so
``dataclasses.asdict`` of the two agree.  The model code interprets
every block type of ``block_pattern`` (``dense``, ``moe``, ``mamba2``,
``shared_attn``, ``rwkv6``) and every modality (``text``, ``vlm``,
``audio``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import SplitConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # --- attention ---
    attn_type: str = "gqa"  # gqa | mla | none
    sliding_window: Optional[int] = None
    # --- MLA ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    rwkv_head_dim: int = 64
    hybrid_attn_every: int = 0
    # --- multimodal (the vision tower is a stub) ---
    modality: str = "text"  # text | vlm | audio
    n_image_tokens: int = 0
    d_vision: int = 0
    d_connector: int = 0  # hidden width of the 2-layer MLP connector
    n_codebooks: int = 0
    # --- split learning (the paper's technique) ---
    split: SplitConfig = dataclasses.field(default_factory=SplitConfig)
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True  # training-time policy; no effect on serving
    kv_cache_bits: int = 16
    remat_group: int = 0
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block types."""
        if self.family == "ssm":
            return ("rwkv6",) * self.n_layers
        if self.family == "hybrid":
            return tuple(
                "shared_attn" if (self.hybrid_attn_every
                                  and (i + 1) % self.hybrid_attn_every == 0)
                else "mamba2" for i in range(self.n_layers))
        if self.family == "moe" or self.n_experts > 0:
            return (("dense",) * self.first_dense_layers
                    + ("moe",) * (self.n_layers - self.first_dense_layers))
        return ("dense",) * self.n_layers

    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """Consecutive same-type runs, split at the compressor cut layer."""
        pattern = self.block_pattern()
        cut = self.split.resolve_cut(self.n_layers)
        segs = []
        run_type, run_len = None, 0
        for i, t in enumerate(pattern):
            if t != run_type or i == cut:
                if run_len:
                    segs.append((run_type, run_len))
                run_type, run_len = t, 1
            else:
                run_len += 1
        if run_len:
            segs.append((run_type, run_len))
        return tuple(segs)

    def client_server_segments(self):
        cut = self.split.resolve_cut(self.n_layers)
        client, server, seen = [], [], 0
        for t, n in self.segments():
            (client if seen < cut else server).append((t, n))
            seen += n
        return tuple(client), tuple(server)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4) or 4
        kv = min(self.n_kv_heads, heads) or heads
        updates = dict(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            split=dataclasses.replace(self.split, cut_layer=1),
        )
        if self.n_experts:
            updates.update(n_experts=min(self.n_experts, 4),
                           moe_top_k=min(self.moe_top_k, 2),
                           moe_d_ff=min(self.moe_d_ff or 256, 256),
                           n_shared_experts=min(self.n_shared_experts, 1),
                           first_dense_layers=min(self.first_dense_layers, 1))
        if self.attn_type == "mla":
            updates.update(q_lora_rank=min(self.q_lora_rank, 64),
                           kv_lora_rank=min(self.kv_lora_rank, 32),
                           qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16,
                           head_dim=32)
        if self.family in ("ssm", "hybrid"):
            updates.update(ssm_state=min(self.ssm_state or 16, 16),
                           ssm_headdim=min(self.ssm_headdim, 32),
                           rwkv_head_dim=min(self.rwkv_head_dim, 32),
                           hybrid_attn_every=2 if self.hybrid_attn_every
                           else 0)
        if self.modality == "vlm":
            updates.update(n_image_tokens=min(self.n_image_tokens, 16),
                           d_vision=min(self.d_vision, 64),
                           d_connector=min(self.d_connector or d, 128))
        if self.modality == "audio":
            updates.update(n_codebooks=min(self.n_codebooks, 2))
        return dataclasses.replace(self, **updates)


def default_split(cut_layer: int = -1, method: str = "rdfsq",
                  bits: int = 2) -> SplitConfig:
    return SplitConfig(cut_layer=cut_layer,
                       quant=QuantConfig(method=method, bits=bits))
