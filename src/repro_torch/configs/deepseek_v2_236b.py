"""deepseek-v2-236b [moe, MLA] (port of
``repro/configs/deepseek_v2_236b.py``).

60 layers, d 5 120, 128 heads of Multi-head Latent Attention: q through a
rank-1 536 latent, K / V through a rank-512 latent plus a shared 64-wide
rotary key; q/k of width 128 + 64 = 192 and v of width 128, so prefill and
training run K1 - K3 at (D, Dv) = (192, 128), G 1.  Layer 0 is a dense
block (SwiGLU of width 12 288); layers 1 - 59 are moe blocks of 160 routed
experts of width 1 536, top-6, beside 2 shared experts (one SwiGLU of
width 3 072): 235.7 G parameters.  ``sliding_window`` is carried as the
reference sets it; only the reference's XLA-only ``launch/shapes.py``
reads it.  The 2-bit cut at layer 30.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,          # the dense first layer's width
    vocab_size=102400,
    rope_theta=10000.0,
    sliding_window=4096,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    moe_top_k=6,
    moe_d_ff=1536,
    n_shared_experts=2,
    first_dense_layers=1,
    split=default_split(cut_layer=30),
    source="arXiv:2405.04434 (DeepSeek-V2)",
)
