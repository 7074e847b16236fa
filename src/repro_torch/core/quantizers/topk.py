"""Randomized Top-K sparsification (Zheng et al., IJCAI 2023), a baseline
(port of ``repro/core/quantizers/topk.py``).

Per sample the K highest-magnitude scalars are kept; a further
``rand_frac * K`` slots go to uniform random picks from the rest, scaled
by 1/p so the estimate is unbiased.  K follows the bit width at equal wire
cost (Table 2 counts Top-K at 16K/H bits per scalar): ``K = bits * H / 16``.

The random picks are the top ``k_rand`` of uniform noise restricted to the
non-top-k set, drawn from a ``torch.Generator`` (seed 0 when none is
given).  They cannot equal ``jax.random``'s picks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base
from repro_torch.utils.tree import ste

_NEG = -1e30


def budget(cfg: base.QuantConfig, h: int) -> Tuple[int, int]:
    """(deterministic K, randomized K) for feature size ``h``."""
    k_total = min(max(1, int(round(cfg.bits * h / 16.0))), h)
    k_rand = int(round(k_total * cfg.rand_frac))
    k_det = max(1, k_total - k_rand)
    k_rand = min(k_rand, h - k_det)
    return k_det, k_rand


def _select(cfg: base.QuantConfig, x: torch.Tensor,
            rng: Optional[torch.Generator]):
    b = x.shape[0]
    flat = x.float().reshape(b, -1)
    h = flat.shape[1]
    k_det, k_rand = budget(cfg, h)
    _, det_idx = torch.topk(flat.abs(), k_det, dim=-1)
    if k_rand > 0:
        if rng is None:
            rng = torch.Generator(device=flat.device).manual_seed(0)
        noise = torch.rand(flat.shape, generator=rng,
                           device=rng.device).to(flat.device)
        noise = noise.scatter(1, det_idx, _NEG)  # picks avoid the top-k
        _, rnd_idx = torch.topk(noise, k_rand, dim=-1)
        rnd_scale = 1.0 / (k_rand / max(1, h - k_det))
    else:
        rnd_idx = det_idx.new_zeros((b, 0))
        rnd_scale = 1.0
    idx = torch.cat([det_idx, rnd_idx], dim=-1)
    scale = torch.cat([torch.ones(k_det, device=flat.device),
                       torch.full((rnd_idx.shape[1],), rnd_scale,
                                  device=flat.device)])
    vals = flat.gather(1, idx) * scale  # unbiased estimate
    return idx.to(torch.int32), vals, h


def _scatter(idx: torch.Tensor, vals: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros((idx.shape[0], math.prod(shape[1:])),
                      dtype=torch.float32, device=vals.device)
    out.scatter_(1, idx.long(), vals.float())
    return out.reshape(shape)


def encode(cfg: base.QuantConfig, x: torch.Tensor,
           rng: Optional[torch.Generator] = None) -> CommPayload:
    idx, vals, _ = _select(cfg, x, rng)
    return CommPayload(
        data=vals.to(torch.float16), aux=dict(indices=idx),
        meta=dict(method="topk", impl="plain", bits=cfg.bits,
                  shape=tuple(x.shape), dtype=x.dtype))


def decode(cfg: base.QuantConfig, payload: CommPayload) -> torch.Tensor:
    return _scatter(payload.aux["indices"], payload.data.float(),
                    payload.meta["shape"]).to(payload.meta["dtype"])


def roundtrip(cfg: base.QuantConfig, x: torch.Tensor,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    idx, vals, _ = _select(cfg, x, rng)
    vals16 = vals.to(torch.float16).float()
    x_hat = _scatter(idx, vals16, x.shape).to(x.dtype)
    return ste(x, x_hat), torch.zeros((), dtype=torch.float32,
                                      device=x.device)


base.register("topk", encode, decode, roundtrip)
