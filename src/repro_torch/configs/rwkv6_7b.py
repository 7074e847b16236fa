"""rwkv6-7b [ssm]: Finch, an attention-free RWKV6 stack with a
data-dependent decay [arXiv:2404.05892] (port of
``repro/configs/rwkv6_7b.py``).

32 ``rwkv6`` layers, d 4 096: each a time mix (the 5-way low-rank token
shift, 64 heads of 64 with a fp32 (64 x 64) WKV state a head, the group
norm, a SiLU gate) and a channel mix (relu^2 of a 14 336 expansion, a
sigmoid gate); vocab 65 536: 7.57 G parameters.  No TPU kernel stands
behind the layer, and its 2-bit cut at layer 16 runs in the graph as the
plain STE roundtrip.  ``n_heads`` / ``n_kv_heads`` are carried as the
reference sets them (d_model / rwkv_head_dim); no attention reads them.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    attn_type="none",
    rwkv_head_dim=64,
    split=default_split(cut_layer=16),
    source="arXiv:2404.05892 (RWKV6 Finch 7B)",
)
