"""The fused wire codecs behind the quantizer dispatch (port of
``repro/core/quantizers/pallas_codecs.py``): RD-FSQ on K4 / K5, NF-b on
K10 / K11.

The codecs pack per sample row (RD-FSQ) or per block (NF) into the kernel
slot layout (``kernels/ops.py``) and tag their payloads
``meta["impl"] = "kernel"``, so ``base.decode`` sends them back here.  On
CUDA tensors encode and decode launch the hand-written kernels; on CPU
tensors the same wrappers run the kernels' plain versions.

Which configs a kernel covers is a static rule on the config, the
reference's own (``pallas_codecs.py``), decided before anything runs:

- RD-FSQ: ``bits`` in ``KERNEL_SLOT_BITS``, ``stats_axis="sample"`` and a
  leading sample axis (``x.ndim >= 2``);
- NF-b: ``bits`` in ``KERNEL_SLOT_BITS`` and ``block_size`` a multiple of
  ``8 // storage_bits(bits)`` (no block straddles a packed word).

Any other config has no kernel in either package: it is encoded by the
method's flat-stream plain encoder (exact bitstream packing, statistics
over the tensor where asked), whose payloads carry ``impl="plain"``.  No
launch is tried and nothing is caught: a config the rule admits gets the
kernel or an error.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.packing import KERNEL_SLOT_BITS, storage_bits
from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base, nf, rdfsq
from repro_torch.kernels import ops


def rdfsq_has_kernel(cfg: base.QuantConfig, ndim: int) -> bool:
    return (cfg.bits in KERNEL_SLOT_BITS and cfg.stats_axis == "sample"
            and ndim >= 2)


def nf_has_kernel(cfg: base.QuantConfig) -> bool:
    return (cfg.bits in KERNEL_SLOT_BITS
            and cfg.block_size % (8 // storage_bits(cfg.bits)) == 0)


def _rdfsq_encode(cfg: base.QuantConfig, x: torch.Tensor,
                  rng: Optional[torch.Generator] = None) -> CommPayload:
    if not rdfsq_has_kernel(cfg, x.ndim):
        return rdfsq.encode(cfg, x, rng)
    words, stats = ops.rdfsq_quantize(x, cfg.bits, cfg.clip_sigma)
    return CommPayload(
        data=words,
        scales=stats,
        meta=dict(method="rdfsq", impl="kernel", bits=cfg.bits,
                  shape=tuple(x.shape), dtype=x.dtype),
    )


def _rdfsq_decode(cfg: base.QuantConfig, payload: CommPayload
                  ) -> torch.Tensor:
    shape = payload.meta["shape"]
    x2d = ops.rdfsq_dequantize(payload.data, payload.scales, cfg.bits,
                               math.prod(shape[1:]),
                               out_dtype=payload.meta["dtype"])
    return x2d.reshape(shape)


def _nf_encode(cfg: base.QuantConfig, x: torch.Tensor,
               rng: Optional[torch.Generator] = None) -> CommPayload:
    if not nf_has_kernel(cfg):
        return nf.encode(cfg, x, rng)
    words, scales, aux = ops.nf_quantize(
        x, cfg.bits, block=cfg.block_size, double_quant=cfg.double_quant,
        dq_group=cfg.dq_group)
    return CommPayload(
        data=words, scales=scales, aux=aux,
        meta=dict(method="nf", impl="kernel", bits=cfg.bits,
                  shape=tuple(x.shape), dtype=x.dtype, n=x.numel(),
                  double_quant=cfg.double_quant),
    )


def _nf_decode(cfg: base.QuantConfig, payload: CommPayload) -> torch.Tensor:
    flat = ops.nf_dequantize(
        payload.data, payload.scales, payload.aux, cfg.bits,
        payload.meta["n"], block=cfg.block_size,
        double_quant=payload.meta["double_quant"], dq_group=cfg.dq_group,
        out_dtype=payload.meta["dtype"])
    return flat.reshape(payload.meta["shape"])


base.register_backend("rdfsq", "kernel", _rdfsq_encode, _rdfsq_decode)
base.register_backend("nf", "kernel", _nf_encode, _nf_decode)
