"""llama3.2-3b, dense (port of ``repro/configs/llama3_2_3b.py``): the arch
of every target of the split pipeline.

28 layers, d 3072, 24 / 8 heads of width 128 (G = 3), SwiGLU d_ff 8192,
vocab 128 256.  ``sliding_window`` is carried as the reference sets it;
the pipeline's blocks run without a window.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    sliding_window=4096,
    split=default_split(cut_layer=14),
    source="hf:meta-llama/Llama-3.2-1B (scaled to 3B per assignment)",
)
