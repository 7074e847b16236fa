"""Split-learning boundary: the in-graph compressor (port of
``repro/core/split.py``, lines 31-133).

``compressor_roundtrip`` is the paper's Figure-2 path with the wire
replaced by identity: learnable linear encoder, RD-FSQ roundtrip with the
straight-through estimator and the commitment loss, learnable linear
decoder.  The real wire (``quantized_ship``, ``WireLink``) is ROADMAP item
M6; the serving engine ships its connector activations through
``quantizers.encode`` / ``decode`` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import quantizers
from repro_torch.core.quantizers import QuantConfig


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Where and how the model is cut; the reference's fields and
    defaults.  ``n_stages`` / ``stage_quants`` describe the pipeline
    topology of ROADMAP item M6 and are carried, not used, here."""

    cut_layer: int = -1  # boundary index into the block stack; -1 = L // 2
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    learnable_codec: bool = True  # Figure-2 linear encoder/decoder
    enabled: bool = True
    n_stages: int = 2
    stage_quants: Tuple[QuantConfig, ...] = ()

    def resolve_cut(self, n_layers: int) -> int:
        cut = self.cut_layer if self.cut_layer >= 0 else n_layers // 2
        return min(max(cut, 0), n_layers)


def client_encode_pre(params: Optional[Dict], cfg: SplitConfig,
                      x: torch.Tensor) -> torch.Tensor:
    if cfg.learnable_codec and params is not None:
        return x @ params["enc_w"].to(x.dtype) + params["enc_b"].to(x.dtype)
    return x


def server_decode_post(params: Optional[Dict], cfg: SplitConfig,
                       x_hat: torch.Tensor) -> torch.Tensor:
    if cfg.learnable_codec and params is not None:
        return (x_hat @ params["dec_w"].to(x_hat.dtype)
                + params["dec_b"].to(x_hat.dtype))
    return x_hat


def compressor_roundtrip(params: Optional[Dict], cfg: SplitConfig,
                         x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (server-side feature, commitment loss)."""
    if not cfg.enabled or cfg.quant.method == "none":
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = client_encode_pre(params, cfg, x)
    h_hat, commit = quantizers.roundtrip(cfg.quant, h)
    return server_decode_post(params, cfg, h_hat), commit
