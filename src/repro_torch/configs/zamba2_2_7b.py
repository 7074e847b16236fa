"""zamba2-2.7b [hybrid]: a Mamba2 backbone and a parameter-shared
attention block every 6 layers [arXiv:2411.15242] (port of
``repro/configs/zamba2_2_7b.py``).

54 layers, d 2 560: 45 ``mamba2`` layers (SSD, d_inner 5 120 as 80 heads
of 64, d_state 64, no TPU kernel behind it) and 9 uses of one
``shared_attn`` block (layers 5, 11, ..., 53), which reads concat(hidden,
the embedded input) through a 2d -> d projection and runs 32 / 32 heads
of width 80 (G 1: K1 - K3 at (80, 80), K6 / K7 at 80) and a SwiGLU of
10 240: 2.09 G parameters.  The 2-bit cut at layer 27: 4 shared blocks on
the client, 5 on the server.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    hybrid_attn_every=6,
    split=default_split(cut_layer=27),
    source="arXiv:2411.15242 (Zamba2-2.7B)",
)
