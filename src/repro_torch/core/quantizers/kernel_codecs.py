"""The fused RD-FSQ wire codec behind the quantizer dispatch (port of
``repro/core/quantizers/pallas_codecs.py``; the NF codec is ROADMAP item
M8).

The codec packs the codes of each sample row into its own words (the
kernel slot layout, ``kernels/ops.py``) and tags its payloads
``meta["impl"] = "kernel"``, so ``base.decode`` sends them back here.  On
CUDA tensors encode and decode launch the hand-written kernels K4 and
K5; on CPU tensors the same wrappers run the kernels' plain versions.

Unlike the reference there is no fallback: a width outside
``KERNEL_SLOT_BITS`` or ``stats_axis='tensor'`` raises instead of
switching to another encoder.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.packing import KERNEL_SLOT_BITS
from repro_torch.core.payload import CommPayload
from repro_torch.core.quantizers import base
from repro_torch.kernels import ops


def _rdfsq_encode(cfg: base.QuantConfig, x: torch.Tensor) -> CommPayload:
    if x.ndim < 2:
        raise ValueError("the kernel codec needs a leading sample axis")
    if cfg.stats_axis != "sample":
        raise NotImplementedError(
            "the kernel codec computes per-sample stats only "
            f"(stats_axis={cfg.stats_axis!r})")
    if cfg.bits not in KERNEL_SLOT_BITS:
        raise NotImplementedError(
            f"{cfg.bits}-bit codes need the cross-byte bitstream packers "
            "(ROADMAP queue M, item M8)")
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


base.register_backend("rdfsq", "kernel", _rdfsq_encode, _rdfsq_decode)
