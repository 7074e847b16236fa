"""Split-learning boundary: the in-graph compressor (port of
``repro/core/split.py``, lines 31-133 and 530-554).

``compressor_roundtrip`` is the paper's Figure-2 path with the wire
replaced by identity: learnable linear encoder, the quantizer's roundtrip
with the straight-through estimator (RD-FSQ adds its commitment loss),
learnable linear decoder.  Any registered method serves, through its plain
roundtrip; no kernel runs in-graph.  ``wire_payload`` is the client's
wire form for byte accounting and ``analytic_bits_per_scalar`` the
Table-2 closed forms.  The real wire (``quantized_ship``, ``WireLink``) is
ROADMAP item M6; the serving engine ships its connector activations
through ``quantizers.encode`` / ``decode`` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import quantizers
from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.quantizers.topk import budget as topk_budget


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
                         x: torch.Tensor,
                         rng: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (server-side feature, commitment loss).  ``rng`` feeds the
    randomized quantizer (Top-K); the others ignore it."""
    if not cfg.enabled or cfg.quant.method == "none":
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = client_encode_pre(params, cfg, x)
    h_hat, commit = quantizers.roundtrip(cfg.quant, h, rng)
    return server_decode_post(params, cfg, h_hat), commit


def wire_payload(cfg: SplitConfig, params: Optional[Dict], x: torch.Tensor,
                 rng: Optional[torch.Generator] = None) -> CommPayload:
    """Client-side wire form (for byte accounting)."""
    h = client_encode_pre(params, cfg, x)
    return quantizers.encode(cfg.quant, h, rng)


def analytic_bits_per_scalar(q: QuantConfig, h_dim: int) -> float:
    """Paper Table 2 closed forms; a grouped plan's rate is its mean width
    (exact: the bitstream packers charge every width its true cost)."""
    if q.method in ("fsq", "rdfsq", "nf"):
        return q.mean_bits() if q.grouped else float(q.bits)
    if q.method == "topk":
        k_det, k_rand = topk_budget(q, h_dim)
        return 16.0 * (k_det + k_rand) / h_dim
    if q.method == "identity":
        return 16.0
    raise ValueError(q.method)
