"""RD-FSQ, the paper's Algorithm 2 (port of
``repro/core/quantizers/rdfsq.py``).

Clip to mu +- k sigma, min-max scale onto [-1, 1], round onto 2^bits
symmetric levels; the cosine commitment loss regularises the distortion.
The wire payload is the packed codes plus two fp16 scalars (lo, hi) per
statistics group.

``encode`` here packs one flat code stream with the exact bitstream
packer at every width 1-8 (the reference's jnp layout), with statistics
per sample row or, for ``stats_axis="tensor"``, over the whole tensor.
The per-row kernel codec is ``kernel_codecs.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.packing import pack_bits, unpack_bits
from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base
from repro_torch.kernels.ref import div_exact
from repro_torch.utils.tree import ste

_EPS = 1e-6


def _scale(cfg: base.QuantConfig, x: torch.Tensor):
    """Clip to mu +- k*sigma then min-max scale onto [-1, 1]."""
    xf = x.float()
    axes = base.stats_axes(cfg, x.ndim)
    mu = xf.mean(dim=axes, keepdim=True)
    # population sigma, as jnp.std (ddof=0); torch.std defaults to ddof=1
    sigma = xf.std(dim=axes, correction=0, keepdim=True)
    xc = torch.clamp(xf, mu - cfg.clip_sigma * sigma,
                     mu + cfg.clip_sigma * sigma)
    lo = xc.amin(dim=axes, keepdim=True)
    hi = xc.amax(dim=axes, keepdim=True)
    e = 2.0 * (xc - lo) / (hi - lo + _EPS) - 1.0
    return e, lo, hi


def _quantize(cfg: base.QuantConfig, x: torch.Tensor):
    d = cfg.levels
    half = (d - 1) / 2.0
    e, lo, hi = _scale(cfg, x)
    z = base.symmetric_round(e, d)
    idx = (z + half).to(torch.uint8)
    return e, z, idx, lo, hi


def _commit_loss(cfg: base.QuantConfig, e: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """L_comm = 1 - cos((d-1)/2 * e, sg(z)) over per-sample vectors."""
    half = (cfg.levels - 1) / 2.0
    a = (half * e).reshape(e.shape[0], -1)
    b = z.detach().reshape(z.shape[0], -1)
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1)
                     + _EPS)
    return torch.mean(1.0 - num / den)


def _reconstruct(cfg: base.QuantConfig, idx: torch.Tensor, lo, hi):
    half = (cfg.levels - 1) / 2.0
    c = div_exact(idx.float() - half, half)  # Algorithm 2 line 9
    return (c + 1.0) / 2.0 * (hi - lo) + lo


def encode(cfg: base.QuantConfig, x: torch.Tensor,
           rng: Optional[torch.Generator] = None) -> CommPayload:
    _, _, idx, lo, hi = _quantize(cfg, x)
    scales = torch.stack([lo.reshape(-1), hi.reshape(-1)],
                         dim=-1).to(torch.float16)
    return CommPayload(
        data=pack_bits(idx, cfg.bits),
        scales=scales,
        meta=dict(method="rdfsq", impl="plain", bits=cfg.bits,
                  shape=tuple(x.shape), dtype=x.dtype,
                  stats_shape=tuple(lo.shape)),
    )


def decode(cfg: base.QuantConfig, payload: CommPayload) -> torch.Tensor:
    shape = payload.meta["shape"]
    stats_shape = payload.meta["stats_shape"]
    idx = unpack_bits(payload.data, cfg.bits, math.prod(shape)
                      ).reshape(shape)
    lo = payload.scales[:, 0].float().reshape(stats_shape)
    hi = payload.scales[:, 1].float().reshape(stats_shape)
    return _reconstruct(cfg, idx, lo, hi).to(payload.meta["dtype"])


def roundtrip(cfg: base.QuantConfig, x: torch.Tensor,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    e, z, idx, lo, hi = _quantize(cfg, x)
    # the wire carries fp16 lo/hi: round them the same way in-graph so the
    # roundtrip equals decode(encode(x)) exactly
    lo16 = lo.to(torch.float16).float()
    hi16 = hi.to(torch.float16).float()
    x_hat = _reconstruct(cfg, idx, lo16, hi16).to(x.dtype)
    commit = _commit_loss(cfg, e, z)
    return ste(x, x_hat), commit


base.register("rdfsq", encode, decode, roundtrip)
