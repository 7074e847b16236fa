"""granite-3-8b, dense GQA (port of ``repro/configs/granite_3_8b.py``).

40 layers, d 4096, 32 / 8 heads of width 128 (G = 4), SwiGLU d_ff 12 800,
vocab 49 155 (odd: embedding and head rows are not 16-byte aligned, which
no kernel reads).  ``sliding_window`` is carried as the reference sets
it; only the reference's XLA-only ``launch/shapes.py`` reads it.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
    sliding_window=4096,
    split=default_split(cut_layer=20),
    source="hf:ibm-granite/granite-3.0-2b-base (8B per assignment)",
)
