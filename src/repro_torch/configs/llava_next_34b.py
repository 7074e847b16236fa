"""llava-next-34b, vlm (port of ``repro/configs/llava_next_34b.py``).

The vision tower is a stub (the batch carries patch embeddings at
d_vision 1 152); the 2-layer GELU connector (1 152 -> 7 168 -> 7 168)
and the decoder backbone (60 layers, d 7168, 56 / 8 heads of width 128,
G = 7) are the model.  The 2-bit cut sits right after the connector
(``cut_layer=0``), the paper's own deployment; 2 880 image tokens model
anyres 4 tiles + the base encoding (5 x 576).
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    modality="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
    sliding_window=4096,
    n_image_tokens=2880,
    d_vision=1152,
    d_connector=7168,
    split=default_split(cut_layer=0),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B-scale backbone)",
)
