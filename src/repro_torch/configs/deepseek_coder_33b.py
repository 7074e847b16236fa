"""deepseek-coder-33b, dense GQA, llama arch (port of
``repro/configs/deepseek_coder_33b.py``).

62 layers, d 7168, 56 / 8 heads of width 128 (G = 7), SwiGLU d_ff
19 200, vocab 32 256, the 2-bit cut at layer 31.  ``sliding_window`` is
carried as the reference sets it.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    sliding_window=4096,
    split=default_split(cut_layer=31),
    source="arXiv:2401.14196 (DeepSeek-Coder 33B)",
)
