"""minicpm3-4b, dense with Multi-head Latent Attention (port of
``repro/configs/minicpm3_4b.py``).

62 layers, d 2560, 40 heads; q through a rank-768 latent, K / V through a
rank-256 latent plus a shared 32-wide rotary key; q/k of width 64 + 32 =
96 and v of width 64, so prefill and training run K1 - K3 at (D, Dv) =
(96, 64); decode is the absorbed-weight form over the latent ring cache
(``models/layers/mla.py``).  The 2-bit cut at layer 31.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    rope_theta=10000.0,
    sliding_window=4096,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    split=default_split(cut_layer=31),
    source="hf:openbmb/MiniCPM3-4B",
)
