"""Plain PyTorch versions of the wire kernels K4 / K5 (RD-FSQ) and K10 /
K11 (NF-b), and of the packed dequant-matmul K12 (port of
``repro/kernels/ref.py``, RD-FSQ, NF and wq parts).

``kernels/ops.py`` and ``wq/ops.py`` run these on CPU tensors; on the
card they are what the CUDA kernels are held against.  The wire kernels
pack one code per power-of-two slot of a uint8 word, LSB first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packing import storage_bits

_EPS = 1e-6


def _pack_slots(codes2d: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, C) codes -> (R, C / per) uint8 words, per-slot shift-or."""
    sb = storage_bits(bits)
    per = 8 // sb
    r, c = codes2d.shape
    grouped = codes2d.to(torch.uint8).reshape(r, c // per, per)
    shifts = torch.arange(per, dtype=torch.uint8,
                          device=codes2d.device) * sb
    return (grouped << shifts).sum(dim=-1).to(torch.uint8)


def _unpack_slots(words: torch.Tensor, bits: int, c: int) -> torch.Tensor:
    """Inverse of :func:`_pack_slots`: (R, C / per) words -> (R, C)."""
    sb = storage_bits(bits)
    per = 8 // sb
    shifts = torch.arange(per, dtype=torch.uint8, device=words.device) * sb
    mask = (1 << sb) - 1
    return ((words[..., None] >> shifts) & mask).reshape(words.shape[0], c)


def div_exact(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b``, correctly rounded on every device.

    PyTorch divides a CUDA tensor by a Python scalar as a product with the
    scalar's reciprocal, which is one ulp off wherever ``1 / b`` is not
    exact (``b`` = 7.5 or 127.5 here).  A 0-dim tensor on ``a``'s device
    takes the true division, as the CPU and the CUDA kernels do."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def rdfsq_stats(x2d: torch.Tensor, clip_sigma: float = 3.0):
    """Per-row (lo, hi) after the mu +- k*sigma clip.  x2d: (R, C)."""
    xf = x2d.float()
    mu = xf.mean(dim=1, keepdim=True)
    sd = xf.std(dim=1, correction=0, keepdim=True)  # population sigma
    xc = torch.clamp(xf, mu - clip_sigma * sd, mu + clip_sigma * sd)
    return xc.amin(dim=1, keepdim=True), xc.amax(dim=1, keepdim=True)


def rdfsq_codes_ref(x2d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """(R, C) codes in {0 .. 2^bits - 1} (uint8, before packing)."""
    d = 2 ** bits
    half = (d - 1) / 2.0
    xf = torch.clamp(x2d.float(), lo, hi)
    e = 2.0 * (xf - lo) / (hi - lo + _EPS) - 1.0
    # d = 2^bits is even: the grid is half-integer
    z = torch.round(half * e - 0.5) + 0.5
    z = torch.clamp(z, -half, half)
    return (z + half).to(torch.uint8)


def rdfsq_quantize_ref(x2d, lo, hi, bits: int) -> torch.Tensor:
    """Packed uint8 words in kernel slot layout: (R, C / per)."""
    return _pack_slots(rdfsq_codes_ref(x2d, lo, hi, bits), bits)


def rdfsq_dequantize_ref(packed: torch.Tensor, lo, hi, bits: int,
                         n_cols: int) -> torch.Tensor:
    d = 2 ** bits
    half = (d - 1) / 2.0
    codes = _unpack_slots(packed, bits, n_cols)
    cvals = div_exact(codes.float() - half, half)
    return (cvals + 1.0) / 2.0 * (hi - lo) + lo


# ---------------------------------------------------------------------------
# NF-b blockwise quantization (K10 / K11)
# ---------------------------------------------------------------------------

def nf_nearest(norm: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """The nearest codebook entry to each fp32 ``norm`` (uint8), the first
    one on a tie (as ``jnp.argmin`` and ``torch.argmin``); a NaN or an
    infinite ``norm`` has every distance NaN or inf and takes entry 0."""
    dist = (norm[..., None] - book.float()).abs()
    return dist.argmin(dim=-1).to(torch.uint8)


def nf_codes_ref(blocks: torch.Tensor, book: torch.Tensor):
    """blocks (NB, G) -> (codes (NB, G) uint8, m (NB, 1), rng (NB, 1)) in
    fp32: each value normalized onto [-1, 1] by its block's (min, range),
    then :func:`nf_nearest`.  min and max propagate a NaN."""
    xf = blocks.float()
    m = xf.amin(dim=1, keepdim=True)
    rng = xf.amax(dim=1, keepdim=True) - m
    norm = 2.0 * (xf - m) / (rng + 1e-8) - 1.0
    return nf_nearest(norm, book), m, rng


def nf_quantize_ref(blocks: torch.Tensor, book: torch.Tensor, bits: int):
    """(words (NB, G / per) in the slot layout, m, rng) in fp32."""
    codes, m, rng = nf_codes_ref(blocks, book)
    return _pack_slots(codes, bits), m, rng


def nf_dequantize_ref(packed: torch.Tensor, m: torch.Tensor,
                      rng: torch.Tensor, book: torch.Tensor, bits: int,
                      g: int) -> torch.Tensor:
    """(NB, G) fp32 from slot-packed codes and per-block (m, rng)."""
    norm = book.float()[_unpack_slots(packed, bits, g).long()]
    return (norm + 1.0) / 2.0 * rng + m


# ---------------------------------------------------------------------------
# weight-only packed dequant-matmul (K12)
# ---------------------------------------------------------------------------
#
# The packed weight store lays the exact core.packing bitstream down the
# input axis PER OUTPUT COLUMN: 8 consecutive codes of a column span
# exactly ``bits`` whole bytes, read here as one little-endian word (held
# in int64), independent of core/packing.py and of the CUDA kernel.

def wq_unpack_ref(words: torch.Tensor, bits: int, d_in: int) -> torch.Tensor:
    """(packed_rows, C) uint8 column bitstreams -> (d_in, C) uint8 codes."""
    nb = (d_in + 7) // 8  # 8-code octets per column
    c = words.shape[1]
    pad = nb * bits - words.shape[0]
    w = F.pad(words, (0, 0, 0, max(pad, 0))).long().reshape(nb, bits, c)
    byte_shifts = (torch.arange(bits, device=words.device) * 8)[None, :, None]
    word = (w << byte_shifts).sum(dim=1)  # (nb, C): 8 codes each
    code_shifts = (torch.arange(8, device=words.device) * bits)[None, :, None]
    codes = (word[:, None, :] >> code_shifts) & (2 ** bits - 1)
    return codes.reshape(nb * 8, c)[:d_in].to(torch.uint8)


def wq_dequant_ref(words: torch.Tensor, scales: torch.Tensor,
                   mins: torch.Tensor, *, bits: int, group: int,
                   d_in: int) -> torch.Tensor:
    """fp32 (d_in, C) weights in STORAGE channel order: ``code * scale``
    then ``+ min``, each rounded (two operations, no fused multiply-add)."""
    codes = wq_unpack_ref(words, bits, d_in).float()
    n_groups, c = scales.shape
    cf = F.pad(codes, (0, 0, 0, n_groups * group - d_in))
    w = cf.reshape(n_groups, group, c) * scales.float()[:, None, :] \
        + mins.float()[:, None, :]
    return w.reshape(n_groups * group, c)[:d_in]


def wq_matmul_ref(x2d: torch.Tensor, words: torch.Tensor,
                  scales: torch.Tensor, mins: torch.Tensor, *, bits: int,
                  group: int, d_in: int) -> torch.Tensor:
    """(M, d_in) @ dequant(words) -> (M, C) fp32.

    The weights are rounded to the activation dtype, as the dense
    ``x @ w.to(x.dtype)`` path rounds them, and the product accumulates in
    fp32: bf16 operands are exact in fp32, so an fp32 product of the
    upcast operands is the bf16 contraction with an fp32 accumulator.
    """
    w = wq_dequant_ref(words, scales, mins, bits=bits, group=group,
                       d_in=d_in).to(x2d.dtype)
    return torch.matmul(x2d.float(), w.float())
