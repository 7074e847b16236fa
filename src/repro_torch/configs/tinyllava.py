"""The paper's own model: Quantized-TinyLLaVA (port of
``repro/configs/tinyllava.py``).

SigLIP-SO400M vision tower as a stub producing 729 patch embeddings at
d_vision=1152; the 2-layer GELU connector and an OpenELM-270M-class
decoder (16 layers, d=1280).  Cut after the connector with a 2-bit RD-FSQ
compressor: the paper's headline configuration.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="tinyllava",
    family="vlm",
    modality="vlm",
    n_layers=16,
    d_model=1280,
    n_heads=20,
    n_kv_heads=5,
    head_dim=64,
    d_ff=3456,
    vocab_size=32000,
    rope_theta=10000.0,
    sliding_window=4096,
    n_image_tokens=729,
    d_vision=1152,
    d_connector=1280,
    split=default_split(cut_layer=0, method="rdfsq", bits=2),
    source="paper SS4.1: SigLIP-SO400M (stub) + OpenELM-270M-class LM",
)
