"""Wrappers of the wire kernels: RD-FSQ K4 / K5 and NF-b K10 / K11 (port
of ``repro/kernels/ops.py``, RD-FSQ and NF parts).

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

K4 / K5 have two hand-written paths, chosen by :func:`rdfsq_path` from
the shapes and the operands' addresses alone, before the launch: the
vector path (16-byte loads and stores, 8 bytes of words a thread) when
every dense row (``x`` for K4, the output for K5) starts 16-byte aligned
and every word row 8-byte aligned; the scalar path (one thread per
packed byte) otherwise.  Both give the same words and outputs.

NF-b: the flat input is read as blocks of G values, its ragged tail as
zeros (the reference pads with zeros to a multiple of G, and the blocks
to a multiple of 128 that it slices off again; the plain version pads to
G only, since every block stands alone).  K10 writes the slot-packed
words and per-block fp16 (m, rng); the double quantization of the ranges
(1/G of the data) runs outside the kernel, in PyTorch, as in the
reference.  Dequantize rebuilds the ranges and rounds them to fp16
before K11, as the reference wrapper does.  K10 / K11 also have two
paths, chosen by :func:`nf_path`: the vector path (16-byte loads or
stores, a lane group per block) takes K10's codes from a per-bits table
of decision points in buckets (:func:`nf_code_table`) and K11's values
from a per-bits table of ``(book + 1) / 2`` (:func:`nf_half_table`); the scalar
path (a warp per block for K10, a thread per word byte for K11) is the
first design.  Both give the plain version's bits.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.packing import KERNEL_SLOT_BITS, storage_bits
from repro_torch.kernels import build
from repro_torch.kernels.ref import (div_exact, nf_dequantize_ref,
                                     nf_quantize_ref, rdfsq_dequantize_ref,
                                     rdfsq_quantize_ref, rdfsq_stats)

ROWS = 8
COLS = 1024
_MAX_ROWS = 65535  # grid.y of the scalar K4 / K5 launch


def _pad_to(x: torch.Tensor, mult: int, axis: int,
            value: float = 0.0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths, value=value)


def _check_operands(bits: int, *tensors: torch.Tensor) -> None:
    if bits not in KERNEL_SLOT_BITS:
        raise ValueError(f"the wire kernels pack {KERNEL_SLOT_BITS} bits")
    if not tensors[0].is_cuda or \
            any(t.device != tensors[0].device for t in tensors):
        raise ValueError("wire kernel operands must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wire kernels take contiguous operands")


def _check_cuda(bits: int, r: int, *tensors: torch.Tensor) -> None:
    _check_operands(bits, *tensors)
    if not 0 < r <= _MAX_ROWS:
        raise ValueError(f"{r} rows: the wire kernels take 1..{_MAX_ROWS}")


def rdfsq_path(cols: int, bits: int, dtype, dense_ptr: int,
               words_ptr: int) -> str:
    """Which K4 / K5 kernel takes (R, ``cols``) rows of ``dtype`` (bf16 or
    fp32) at ``dense_ptr`` and their words at ``words_ptr``: ``"vector"``
    when every dense row starts 16-byte aligned (``cols * itemsize`` and
    the base a multiple of 16) and every word row 8-byte aligned
    (``ceil(cols / per)`` and the base a multiple of 8), else
    ``"scalar"``."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    n_words = -(-cols // (8 // storage_bits(bits)))
    vector = (cols * itemsize % 16 == 0 and dense_ptr % 16 == 0
              and n_words % 8 == 0 and words_ptr % 8 == 0)
    return "vector" if vector else "scalar"


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
    path = rdfsq_path(c, bits, x2d.dtype, x2d.data_ptr(), words.data_ptr())
    build.launch("rdfsq_quantize", "rdfsq_quantize", x2d.data_ptr(),
                 int(x2d.dtype == torch.bfloat16), stats.data_ptr(),
                 words.data_ptr(), r, c, bits, int(path == "vector"),
                 build.current_stream())
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
    build.refuse_dtensor("rdfsq_quantize", x)
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
    path = rdfsq_path(n_cols, bits, out_dtype, out.data_ptr(),
                      words.data_ptr())
    build.launch("rdfsq_dequantize", "rdfsq_dequantize", words.data_ptr(),
                 stats.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), r, n_cols, bits,
                 int(path == "vector"), build.current_stream())
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
    build.refuse_dtensor("rdfsq_dequantize", words, stats)
    dequantize = dequantize_kernel if words.is_cuda else dequantize_plain
    return dequantize(words, stats.float(), bits, n_cols, out_dtype)


# ---------------------------------------------------------------------------
# NF-b (QLoRA): K10 / K11
# ---------------------------------------------------------------------------

_NF_EPS = 1e-8
_NF_MAX_CHUNKS = 64  # 16-byte chunks of a block on K10 / K11's vector path


def _float_keys(f: np.ndarray) -> np.ndarray:
    """float32 -> int64 keys in the floats' order (-0 just below +0); the
    map is its own inverse on the int32 patterns (:func:`_key_floats`)."""
    b = np.asarray(f, np.float32).view(np.int32).astype(np.int64)
    return np.where(b >= 0, b, b ^ 0x7fffffff)


def _key_floats(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.int64)
    return np.where(k >= 0, k, k ^ 0x7fffffff).astype(np.int32).view(
        np.float32)


@lru_cache(maxsize=None)
def nf_code_thresholds(bits: int) -> Tuple[float, ...]:
    """K10's decision points: for c = 1 .. 2^bits - 1, the least float32
    quotient ``q = fl(fl(2 fl(x - m)) / den)`` in [0, 2] whose code (the
    nearest codebook entry to ``fl(q - 1)``, the first on a tie, as
    ``ref.nf_nearest``) is at least c, found by bisection over the ordered
    float32 patterns.  A finite ``q`` lies in [0, 2], where the code is a
    nondecreasing step function of it, so its code is the number of these
    points at or below it (the CPU tests hold this at every point +-64
    ulps); a NaN or +inf ``q`` takes code 0."""
    from repro_torch.core.quantizers.nf import nf_codebook

    book = np.asarray(nf_codebook(bits), np.float32)

    def codes(keys):
        norm = _key_floats(keys) - np.float32(1.0)
        return np.argmin(np.abs(norm[:, None] - book[None, :]), axis=1)

    want = np.arange(1, 2 ** bits)
    lo = np.full(want.shape, _float_keys(np.float32(0.0)))  # code < c
    hi = np.full(want.shape, _float_keys(np.float32(2.0)))  # code >= c
    assert (codes(lo) < want).all() and (codes(hi) >= want).all()
    while (hi - lo > 1).any():
        mid = lo + (hi - lo) // 2
        holds = codes(mid) >= want
        hi, lo = np.where(holds, mid, hi), np.where(holds, lo, mid)
    return tuple(float(t) for t in _key_floats(hi))


# K10 finds a quotient's code in one step: bucket b = RN(S q), one fused
# multiply-add onto 1.5 * 2^23 (the bucket in the sum's low bits), holds
# at most one decision point, so the code is base[b] + (q >= point[b]).
# csrc/nf.cu's Decision holds the same scales and bucket counts.
NF_BUCKET_SCALE = {1: 15.0, 2: 15.0, 4: 15.0, 8: 511.0}
NF_BUCKETS = {1: 32, 2: 32, 4: 32, 8: 1024}
_MAGIC = 12582912.0  # 1.5 * 2^23


def nf_bucket(q, bits: int) -> np.ndarray:
    """The kernel's bucket of float32 quotients ``q`` in [0, 2]:
    ``fl(S q + 1.5 * 2^23) - 1.5 * 2^23``, the sum exact in float64 and
    rounded once to float32, as the kernel's FMA rounds it."""
    v = np.asarray(q, np.float64) * NF_BUCKET_SCALE[bits] + _MAGIC
    return (v.astype(np.float32).astype(np.float64) - _MAGIC).astype(
        np.int64)


@lru_cache(maxsize=None)
def nf_code_table(bits: int) -> Tuple[float, ...]:
    """K10's per-bits table, ``2 * NF_BUCKETS[bits]`` float32 values: the
    decision point in each bucket (+inf where there is none), then the
    number of points in the buckets below it."""
    points = np.asarray(nf_code_thresholds(bits), np.float32)
    n = NF_BUCKETS[bits]
    b = nf_bucket(points, bits)
    if len(set(b.tolist())) != len(b) or b.max() >= n:
        raise AssertionError(f"{bits}-bit decision points share a bucket")
    point = np.full(n, np.inf, np.float32)
    point[b] = points
    base = np.searchsorted(b, np.arange(n), side="left").astype(np.float32)
    return tuple(float(v) for v in np.concatenate([point, base]))


@lru_cache(maxsize=None)
def nf_code_table_tensor(bits: int, device: torch.device) -> torch.Tensor:
    """:func:`nf_code_table` as an fp32 tensor on ``device``, made once per
    device (callers do not write to it)."""
    return torch.tensor(nf_code_table(bits), dtype=torch.float32,
                        device=device)


@lru_cache(maxsize=None)
def nf_half_table(bits: int, device: torch.device) -> torch.Tensor:
    """K11's table ``h_c = fl(fl(book_c + 1) / 2)`` (fp32, 2^bits), made
    once per device: ``fl(fl(h_code rng) + m)`` is then the plain
    ``(norm + 1) / 2 * rng + m`` operation for operation."""
    from repro_torch.core.quantizers.nf import codebook_tensor

    return div_exact(codebook_tensor(bits, device) + 1.0, 2.0)


def nf_path(block: int, dtype, dense_ptr: int, words_ptr: int) -> str:
    """Which K10 / K11 kernel takes blocks of ``block`` values of ``dtype``
    (bf16 or fp32) at ``dense_ptr`` (K10's input, K11's output) and their
    words at ``words_ptr``: ``"vector"`` when a block fills whole 16-byte
    chunks, at most 64 of them, the dense base is 16-byte aligned and the
    words' base 8-byte aligned, else ``"scalar"``."""
    nbytes = block * (2 if dtype == torch.bfloat16 else 4)
    vector = (nbytes % 16 == 0 and nbytes // 16 <= _NF_MAX_CHUNKS
              and dense_ptr % 16 == 0 and words_ptr % 8 == 0)
    return "vector" if vector else "scalar"


def _nf_check_args(bits: int, block: int) -> None:
    if bits not in KERNEL_SLOT_BITS:
        raise ValueError(f"the wire kernels pack {KERNEL_SLOT_BITS} bits")
    if block <= 0 or block % (8 // storage_bits(bits)):
        raise ValueError(f"block {block} does not hold whole {bits}-bit "
                         "words")


def nf_quantize_kernel(flat: torch.Tensor, book: torch.Tensor, bits: int,
                       block: int):
    """K10 launch: flat (n,) bf16/fp32 CUDA, read as ceil(n / block)
    blocks (the ragged tail as zeros); book (2^bits,) fp32 -> words
    (NB, block / per) uint8, m (NB, 1) fp16, rng (NB, 1) fp16."""
    _nf_check_args(bits, block)
    if flat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K10 reads bf16 or fp32, got {flat.dtype}")
    if book.dtype != torch.float32 or book.shape != (2 ** bits,):
        raise ValueError("K10 takes a (2^bits,) fp32 codebook")
    _check_operands(bits, flat, book)
    n = flat.numel()
    nb = -(-n // block)
    per = 8 // storage_bits(bits)
    words = torch.empty((nb, block // per), dtype=torch.uint8,
                        device=flat.device)
    m = torch.empty((nb, 1), dtype=torch.float16, device=flat.device)
    rng = torch.empty_like(m)
    path = nf_path(block, flat.dtype, flat.data_ptr(), words.data_ptr())
    build.launch("nf_quantize", "nf_quantize", flat.data_ptr(),
                 int(flat.dtype == torch.bfloat16), book.data_ptr(),
                 nf_code_table_tensor(bits, flat.device).data_ptr(),
                 words.data_ptr(), m.data_ptr(), rng.data_ptr(), n, block,
                 bits, int(path == "vector"), build.current_stream())
    return words, m, rng


def nf_quantize_plain(flat: torch.Tensor, book: torch.Tensor, bits: int,
                      block: int):
    """K10's plain version: the same outputs on any device."""
    blocks = F.pad(flat.float(), (0, (-flat.numel()) % block))
    words, m, rng = nf_quantize_ref(blocks.reshape(-1, block), book, bits)
    return words, m.to(torch.float16), rng.to(torch.float16)


def _nf_double_quant(rng: torch.Tensor, dq_group: int):
    """8-bit codes (NB, 1) of the fp16 block ranges, one fp16 scale per
    ``dq_group`` blocks (``ceil(NB / dq_group)``,)."""
    nb = rng.shape[0]
    groups = F.pad(rng.float(), (0, 0, 0, (-nb) % dq_group)
                   ).reshape(-1, dq_group)
    gscale = groups.abs().amax(dim=-1, keepdim=True)
    codes = torch.round(groups / (gscale + _NF_EPS) * 255.0
                        ).to(torch.uint8)
    return codes.reshape(-1, 1)[:nb], gscale[:, 0].to(torch.float16)


def nf_quantize(x: torch.Tensor, bits: int, block: int = 64,
                double_quant: bool = True, dq_group: int = 256):
    """Blockwise NF-b quantize + pack of ``x`` flattened.  Returns (words
    (NB, block * sb / 8) uint8, scales, aux): with double quantization the
    scales are (NB, 1) uint8 codes and ``aux["dq_scale"]`` the fp16 group
    scales, else the (NB, 1) fp16 ranges; ``aux["block_min"]`` is (NB, 1)
    fp16."""
    from repro_torch.core.quantizers.nf import codebook_tensor

    build.refuse_dtensor("nf_quantize", x)
    flat = x.reshape(-1)
    book = codebook_tensor(bits, flat.device)
    quantize = nf_quantize_kernel if flat.is_cuda else nf_quantize_plain
    words, m, rng = quantize(flat, book, bits, block)
    aux = dict(block_min=m)
    if not double_quant:
        return words, rng, aux
    scales, aux["dq_scale"] = _nf_double_quant(rng, dq_group)
    return words, scales, aux


def nf_dequantize_kernel(words: torch.Tensor, m: torch.Tensor,
                         rng: torch.Tensor, book: torch.Tensor, bits: int,
                         block: int, n: int, out_dtype) -> torch.Tensor:
    """K11 launch: words (NB, block / per) uint8, m and rng (NB, 1) fp16,
    book (2^bits,) fp32 -> the first ``n`` values (n,) in ``out_dtype``
    (bf16 or fp32)."""
    _nf_check_args(bits, block)
    nb = words.shape[0]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K11 writes bf16 or fp32, got {out_dtype}")
    if words.dtype != torch.uint8 or \
            words.shape[1] != block // (8 // storage_bits(bits)):
        raise ValueError("words do not hold blocks of this size")
    if not (nb - 1) * block < n <= nb * block:
        raise ValueError(f"{nb} blocks of {block} do not hold {n} values")
    if any(t.dtype != torch.float16 or t.shape != (nb, 1) for t in (m, rng)):
        raise ValueError("K11 takes (NB, 1) fp16 m and rng")
    if book.dtype != torch.float32 or book.shape != (2 ** bits,):
        raise ValueError("K11 takes a (2^bits,) fp32 codebook")
    _check_operands(bits, words, m, rng, book)
    out = torch.empty((n,), dtype=out_dtype, device=words.device)
    path = nf_path(block, out_dtype, out.data_ptr(), words.data_ptr())
    build.launch("nf_dequantize", "nf_dequantize", words.data_ptr(),
                 m.data_ptr(), rng.data_ptr(), book.data_ptr(),
                 nf_half_table(bits, words.device).data_ptr(),
                 out.data_ptr(), int(out_dtype == torch.bfloat16), n, block,
                 bits, int(path == "vector"), build.current_stream())
    return out


def nf_dequantize_plain(words: torch.Tensor, m: torch.Tensor,
                        rng: torch.Tensor, book: torch.Tensor, bits: int,
                        block: int, n: int, out_dtype) -> torch.Tensor:
    """K11's plain version."""
    x = nf_dequantize_ref(words, m.float(), rng.float(), book, bits, block)
    return x.reshape(-1)[:n].to(out_dtype)


def nf_dequantize(words: torch.Tensor, scales: torch.Tensor, aux: dict,
                  bits: int, n: int, block: int = 64,
                  double_quant: bool = True, dq_group: int = 256,
                  out_dtype=torch.float32) -> torch.Tensor:
    """The first ``n`` values (n,) of the blocks.  With double
    quantization the ranges are rebuilt from their codes and rounded to
    fp16 before the kernel, as the reference wrapper does."""
    from repro_torch.core.quantizers.nf import codebook_tensor

    build.refuse_dtensor("nf_dequantize", words, scales, *aux.values())
    nb = words.shape[0]
    if double_quant:
        codes = F.pad(scales, (0, 0, 0, (-nb) % dq_group)
                      ).reshape(-1, dq_group)
        gscale = aux["dq_scale"].float()
        rng = (div_exact(codes.float(), 255.0) * gscale[:, None]
               ).reshape(-1, 1)[:nb].to(torch.float16)
    else:
        rng = scales
    book = codebook_tensor(bits, words.device)
    dequantize = nf_dequantize_kernel if words.is_cuda \
        else nf_dequantize_plain
    return dequantize(words, aux["block_min"], rng, book, bits, block, n,
                      out_dtype)
