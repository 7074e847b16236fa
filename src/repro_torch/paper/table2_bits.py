"""Paper Table 2: average transmitted bits per scalar, per method (port of
``benchmarks/table2_bits.py``).

The analytic closed forms (the paper's table) beside the bits measured on
the packed payload, which add each method's side information (block
minima and double-quantized ranges for NF, indices for Top-K).  The
measured bits are what crosses the port's wire: the kernel layout where
``kernel_codecs.rdfsq_has_kernel`` / ``nf_has_kernel`` admit the config,
the flat stream elsewhere, and each row names the layout its payload's
``meta["impl"]`` carries.  The reference on the CPU counts its flat
streams, so its NF side information and its 3-bit rows differ from the
kernel layout's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import quantizers
from repro_torch.core.payload import bits_per_scalar
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import analytic_bits_per_scalar
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.paper.common import emit, time_fn

SHAPE = (8, 128, 1280)
METHODS = ("fsq", "rdfsq", "nf", "topk", "identity")


def rows() -> Tuple[Tuple[str, int], ...]:
    """(method, bits) of every row, in the reference's order."""
    return tuple((m, b) for m in METHODS
                 for b in ((16,) if m == "identity" else (1, 2, 3, 4)))


def run(device: DeviceLike = None, shape=SHAPE, seed: int = 0
        ) -> Dict[Tuple[str, int], Dict]:
    """Each row's analytic and measured bits, wire bytes, layout and
    payload, for ``x`` of ``shape`` drawn from ``seed`` (numpy) in fp32 on
    ``device``.  Top-K's random picks come from a CPU generator seeded
    with 1 at every call, so a card and the CPU pick the same."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(dev)
    h = x.numel() // x.shape[0]
    out = {}
    for method, bits in rows():
        cfg = QuantConfig(method=method, bits=min(bits, 8))

        def enc(cfg=cfg):
            return quantizers.encode(cfg, x, torch.Generator().manual_seed(1))

        t_us = time_fn(enc, iters=3, warmup=1)
        payload = enc()
        measured = bits_per_scalar(payload, x.numel())
        analytic = analytic_bits_per_scalar(cfg, h)
        layout = payload.meta["impl"]
        out[(method, bits)] = dict(analytic=analytic, measured=measured,
                                   wire_bytes=payload.wire_bytes(),
                                   layout=layout, payload=payload)
        emit(f"table2/{method}_{bits}bit", t_us,
             f"analytic={analytic:.3f};measured={measured:.3f};"
             f"wire_bytes={payload.wire_bytes()};layout={layout}")
    return out
