"""Wrappers of the RD-FSQ wire kernels K4 / K5 (port of
``repro/kernels/ops.py``, RD-FSQ part).

The statistics pass stays outside the kernel, in PyTorch, as in the
reference; the streaming clip -> scale -> round -> pack (K4) and
unpack -> rescale (K5) run in ``csrc/rdfsq.cu`` for CUDA tensors and in
the plain versions of ``kernels/ref.py`` for CPU tensors.  The payload
carries the stats in fp16; quantize uses them unrounded, dequantize
rounded, as the reference does.

Padding: the reference pads columns with zeros to a multiple of
``COLS`` and rows to a multiple of ``ROWS`` (padded rows get stats of
1.0), runs the kernel and slices the words back to ``ceil(C / per)``.
The plain path does exactly that; the CUDA kernel reads the ragged last
tile as zeros itself, which gives the same words without a padded copy.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import KERNEL_SLOT_BITS, storage_bits
from repro_torch.kernels import build
from repro_torch.kernels.ref import (rdfsq_dequantize_ref,
                                     rdfsq_quantize_ref, rdfsq_stats)

ROWS = 8
COLS = 1024
_MAX_ROWS = 65535  # grid.y of the CUDA launch


def _pad_to(x: torch.Tensor, mult: int, axis: int,
            value: float = 0.0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths, value=value)


def _check_cuda(bits: int, r: int, *tensors: torch.Tensor) -> None:
    if bits not in KERNEL_SLOT_BITS:
        raise ValueError(f"the wire kernels pack {KERNEL_SLOT_BITS} bits")
    if not 0 < r <= _MAX_ROWS:
        raise ValueError(f"{r} rows: the wire kernels take 1..{_MAX_ROWS}")
    if not tensors[0].is_cuda or \
            any(t.device != tensors[0].device for t in tensors):
        raise ValueError("wire kernel operands must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wire kernels take contiguous operands")


def quantize_kernel(x2d: torch.Tensor, stats: torch.Tensor, bits: int
                    ) -> torch.Tensor:
    """K4 launch: x2d (R, C) bf16/fp32 CUDA, stats (R, 2) fp32 (lo, hi)
    -> words (R, ceil(C / per)) uint8."""
    r, c = x2d.shape
    _check_cuda(bits, r, x2d, stats)
    if x2d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 reads bf16 or fp32, got {x2d.dtype}")
    if stats.dtype != torch.float32 or stats.shape != (r, 2):
        raise ValueError("K4 takes (R, 2) fp32 stats")
    words = torch.empty((r, -(-c // (8 // storage_bits(bits)))),
                        dtype=torch.uint8, device=x2d.device)
    build.launch("rdfsq_quantize", "rdfsq_quantize", x2d.data_ptr(),
                 int(x2d.dtype == torch.bfloat16), stats.data_ptr(),
                 words.data_ptr(), r, c, bits, build.current_stream())
    return words


def quantize_plain(x2d: torch.Tensor, stats: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """K4's plain version, padded as the reference pads."""
    r, c = x2d.shape
    xp = _pad_to(_pad_to(x2d.float(), COLS, 1), ROWS, 0)
    statsp = _pad_to(stats, ROWS, 0, value=1.0)
    words = rdfsq_quantize_ref(xp, statsp[:, :1], statsp[:, 1:], bits)
    return words[:r, :-(-c // (8 // storage_bits(bits)))]


def rdfsq_quantize(x: torch.Tensor, bits: int, clip_sigma: float = 3.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused quantize+pack.  x: (B, ...) -> (words (B, ceil(C/per)) uint8,
    stats (B, 2) fp16)."""
    x2d = x.reshape(x.shape[0], -1)
    lo, hi = rdfsq_stats(x2d, clip_sigma)
    stats = torch.cat([lo, hi], dim=1).float()
    quantize = quantize_kernel if x2d.is_cuda else quantize_plain
    return quantize(x2d, stats, bits), stats.to(torch.float16)


def dequantize_kernel(words: torch.Tensor, stats: torch.Tensor, bits: int,
                      n_cols: int, out_dtype) -> torch.Tensor:
    """K5 launch: words (R, ceil(n_cols / per)) uint8 CUDA, stats (R, 2)
    fp32 -> (R, n_cols) in ``out_dtype`` (bf16 or fp32)."""
    r = words.shape[0]
    _check_cuda(bits, r, words, stats)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K5 writes bf16 or fp32, got {out_dtype}")
    if words.dtype != torch.uint8 or \
            words.shape[1] != -(-n_cols // (8 // storage_bits(bits))):
        raise ValueError("words do not hold n_cols codes")
    if stats.dtype != torch.float32 or stats.shape != (r, 2):
        raise ValueError("K5 takes (R, 2) fp32 stats")
    out = torch.empty((r, n_cols), dtype=out_dtype, device=words.device)
    build.launch("rdfsq_dequantize", "rdfsq_dequantize", words.data_ptr(),
                 stats.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), r, n_cols, bits,
                 build.current_stream())
    return out


def dequantize_plain(words: torch.Tensor, stats: torch.Tensor, bits: int,
                     n_cols: int, out_dtype) -> torch.Tensor:
    """K5's plain version, padded as the reference pads."""
    per = 8 // storage_bits(bits)
    wp = _pad_to(_pad_to(words, COLS // per, 1), ROWS, 0)
    statsp = _pad_to(stats, ROWS, 0, value=1.0)
    x = rdfsq_dequantize_ref(wp, statsp[:, :1], statsp[:, 1:], bits,
                             wp.shape[1] * per)
    return x[:words.shape[0], :n_cols].to(out_dtype)


def rdfsq_dequantize(words: torch.Tensor, stats: torch.Tensor, bits: int,
                     n_cols: int, out_dtype=torch.float32) -> torch.Tensor:
    """Unpack + dequantize with the payload's (fp16) stats.  words
    (B, ceil(n_cols/per)) uint8, stats (B, 2) -> (B, n_cols)."""
    dequantize = dequantize_kernel if words.is_cuda else dequantize_plain
    return dequantize(words, stats.float(), bits, n_cols, out_dtype)
