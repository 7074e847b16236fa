"""musicgen-large [audio]: a decoder over EnCodec tokens
[arXiv:2306.05284] (port of ``repro/configs/musicgen_large.py``).

48 dense layers, d 2 048, 32 / 32 heads of width 64 (G 1: K1 - K3 and
K6 / K7 at 64), SwiGLU 8 192; 4 codebooks of 2 048 codes, embedded one
table each and summed, predicted by 4 heads at once (logits (B, S, 4,
2 048)): 3.25 G parameters.  EnCodec itself is a stub, as in the
reference: a batch carries the (B, 4, S) code grid.  The 2-bit cut at
layer 24.  ``sliding_window`` is carried as the reference sets it; only
the reference's XLA-only ``launch/shapes.py`` reads it.
"""
from repro_torch.configs.base import ArchConfig, default_split

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    modality="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0,
    sliding_window=4096,
    n_codebooks=4,
    split=default_split(cut_layer=24),
    source="arXiv:2306.05284 (MusicGen-large)",
)
