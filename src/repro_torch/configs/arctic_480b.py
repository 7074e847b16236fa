"""arctic-480b [moe]: 128 experts top-2 + a dense residual
[hf:Snowflake/snowflake-arctic-base] (port of
``repro/configs/arctic_480b.py``).

35 layers, d 7 168, 56 / 8 heads of width 128 (G = 7); each layer's MoE
feed-forward holds 128 SwiGLU experts of width 4 864 (13.4 G parameters)
beside a dense residual SwiGLU of 4 864.  ``sliding_window`` is carried as
the reference sets it; only the reference's XLA-only ``launch/shapes.py``
reads it.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,           # dense-residual MLP width
    vocab_size=32000,
    rope_theta=10000.0,
    sliding_window=4096,
    n_experts=128,
    moe_top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    split=default_split(cut_layer=17),
    source="hf:Snowflake/snowflake-arctic-base",
)
