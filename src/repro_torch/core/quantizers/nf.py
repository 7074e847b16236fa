"""b-bit NormalFloat (QLoRA) activation quantization, the paper's
Algorithm 3 (port of ``repro/core/quantizers/nf.py``).

- A Gaussian-quantile codebook NF_b of 2^b entries on [-1, 1] with an
  exact zero (asymmetric halves).
- Blockwise normalization: flatten to blocks of G, per-block (min, max)
  onto [-1, 1], nearest codebook entry.
- Double quantization: the per-block ranges are quantized to 8 bits with
  one fp16 scale per group of ``dq_group`` blocks.

The wire payload is the packed codes (one flat exact bitstream here; the
per-block kernel layout is ``kernel_codecs.py``), the uint8 range codes,
the fp16 block minima and the fp16 group scales.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_bits, unpack_bits
from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base
from repro_torch.kernels.ref import div_exact, nf_codes_ref
from repro_torch.utils.tree import ste

_EPS = 1e-8


def _erfinv_scalar(y: float) -> float:
    """erfinv by Newton's method on ``math.erf`` (host side, to ~1e-14)."""
    if y <= -1.0 or y >= 1.0:
        raise ValueError("erfinv domain")
    x = 0.0
    for _ in range(80):
        err = math.erf(x) - y
        d = 2.0 / math.sqrt(math.pi) * math.exp(-x * x)
        step = err / d
        x -= step
        if abs(step) < 1e-15:
            break
    return x


def _norm_ppf(p) -> np.ndarray:
    """Standard normal quantile (host side)."""
    arr = np.atleast_1d(np.asarray(p, dtype=np.float64))
    return np.array([math.sqrt(2.0) * _erfinv_scalar(2.0 * v - 1.0)
                     for v in arr])


@lru_cache(maxsize=None)
def nf_codebook(bits: int) -> Tuple[float, ...]:
    """NF_b codebook: 2^b Gaussian-quantile levels on [-1, 1] with an
    exact 0, the QLoRA construction with the offset 1 - 1/(2 * 2^b)."""
    n = 2 ** bits
    offset = 1.0 - 1.0 / (2 * n)
    pos = _norm_ppf(np.linspace(offset, 0.5, n // 2 + 1))[:-1]
    neg = -_norm_ppf(np.linspace(offset, 0.5, n // 2))[:-1]
    vals = np.sort(np.concatenate([neg[::-1], [0.0], pos[::-1]]))
    vals = vals / np.abs(vals).max()
    assert vals.shape[0] == n
    return tuple(float(v) for v in vals)


@lru_cache(maxsize=None)
def codebook_tensor(bits: int, device: torch.device) -> torch.Tensor:
    """The codebook as an fp32 tensor on ``device``, made once per device
    (callers do not write to it)."""
    return torch.tensor(nf_codebook(bits), dtype=torch.float32,
                        device=device)


def _to_blocks(cfg: base.QuantConfig, x: torch.Tensor):
    flat = x.float().reshape(-1)
    n = flat.numel()
    flat = F.pad(flat, (0, (-n) % cfg.block_size))
    return flat.reshape(-1, cfg.block_size), n


def _block_quantize(cfg: base.QuantConfig, blocks: torch.Tensor):
    """Per-block normalize + nearest NF_b entry (Algorithm 3 l. 3-7)."""
    book = codebook_tensor(cfg.bits, blocks.device)
    q, m, rng = nf_codes_ref(blocks, book)
    return q, m[:, 0], rng[:, 0], book


def _double_quant(cfg: base.QuantConfig, rng_vals: torch.Tensor):
    """8-bit codes of the per-block ranges with fp16 group scales; only
    the ``nb`` real codes ship."""
    nb, gq = rng_vals.shape[0], cfg.dq_group
    groups = F.pad(rng_vals, (0, (-nb) % gq)).reshape(-1, gq)
    gscale = groups.abs().amax(dim=-1, keepdim=True)
    codes = torch.round(groups / (gscale + _EPS) * 255.0).to(torch.uint8)
    return codes.reshape(-1)[:nb], gscale[:, 0].to(torch.float16), nb


def _double_dequant(codes: torch.Tensor, gscale: torch.Tensor, gq: int,
                    nb: int) -> torch.Tensor:
    codes = F.pad(codes.reshape(-1), (0, (-codes.numel()) % gq))
    groups = codes.reshape(-1, gq).float()
    vals = div_exact(groups, 255.0) * gscale.float()[:, None]
    return vals.reshape(-1)[:nb]


def _reconstruct(book: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                 rng_vals: torch.Tensor) -> torch.Tensor:
    """Algorithm 3 lines 15-16."""
    norm = book[q.long()]
    return (norm + 1.0) / 2.0 * rng_vals[:, None] + m[:, None]


def encode(cfg: base.QuantConfig, x: torch.Tensor,
           rng: Optional[torch.Generator] = None) -> CommPayload:
    blocks, n = _to_blocks(cfg, x)
    q, m, rng_vals, _ = _block_quantize(cfg, blocks)
    aux = dict(block_min=m.to(torch.float16))
    if cfg.double_quant:
        scales, gscale, _ = _double_quant(cfg, rng_vals)
        aux["dq_scale"] = gscale
    else:
        scales = rng_vals.to(torch.float16)
    return CommPayload(
        data=pack_bits(q, cfg.bits), scales=scales, aux=aux,
        meta=dict(method="nf", impl="plain", bits=cfg.bits,
                  shape=tuple(x.shape), dtype=x.dtype, n=n,
                  n_blocks=blocks.shape[0], double_quant=cfg.double_quant))


def decode(cfg: base.QuantConfig, payload: CommPayload) -> torch.Tensor:
    n, nb = payload.meta["n"], payload.meta["n_blocks"]
    book = codebook_tensor(cfg.bits, payload.data.device)
    q = unpack_bits(payload.data, cfg.bits, nb * cfg.block_size
                    ).reshape(nb, cfg.block_size)
    m = payload.aux["block_min"].float()
    if payload.meta["double_quant"]:
        rng_vals = _double_dequant(payload.scales, payload.aux["dq_scale"],
                                   cfg.dq_group, nb)
    else:
        rng_vals = payload.scales.float()
    x_hat = _reconstruct(book, q, m, rng_vals)
    return x_hat.reshape(-1)[:n].reshape(payload.meta["shape"]).to(
        payload.meta["dtype"])


def roundtrip(cfg: base.QuantConfig, x: torch.Tensor,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The STE path; it rounds ``m`` to fp16 and uses the double-dequantized
    ranges, so it equals ``decode(encode(x))``."""
    blocks, n = _to_blocks(cfg, x)
    q, m, rng_vals, book = _block_quantize(cfg, blocks)
    m16 = m.to(torch.float16).float()
    if cfg.double_quant:
        codes, gscale, nb = _double_quant(cfg, rng_vals)
        rng_used = _double_dequant(codes, gscale, cfg.dq_group, nb)
    else:
        rng_used = rng_vals.to(torch.float16).float()
    x_hat = _reconstruct(book, q, m16, rng_used)
    x_hat = x_hat.reshape(-1)[:n].reshape(x.shape).to(x.dtype)
    return ste(x, x_hat), torch.zeros((), dtype=torch.float32,
                                      device=x.device)


base.register("nf", encode, decode, roundtrip)
