"""Exact b-bit packing of integer codes into uint8 words (port of
``repro/core/packing.py``).

Two layouts cross the wire:

- the kernel slot layout: one code per power-of-two slot of a byte, code
  ``i`` of a byte at bit shift ``i * storage_bits``, LSB first.  The
  wire kernels (K4 / K5, K10 / K11) write it per row at the widths of
  ``KERNEL_SLOT_BITS``;
- the exact bitstream of ``pack_bits`` / ``unpack_bits``: code ``i``
  occupies stream bits ``[i*bits, (i+1)*bits)``, LSB first within each
  byte, so ``n`` codes cost exactly ``ceil(n * bits / 8)`` bytes at every
  width 1-8.  The plain codecs use it; odd widths have no kernel.

For ``bits`` in ``KERNEL_SLOT_BITS`` the two layouts are the same bytes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Widths the fused kernels pack natively (one code per power-of-two slot).
KERNEL_SLOT_BITS = (1, 2, 4, 8)

# Codes per packing group: 8 codes span exactly ``bits`` whole bytes.
_GROUP = 8


def _check_bits(bits: int) -> None:
    if bits <= 0 or bits > 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")


def storage_bits(bits: int) -> int:
    """Physical bits per code in a kernel slot (next power of two)."""
    _check_bits(bits)
    for b in KERNEL_SLOT_BITS:
        if bits <= b:
            return b
    raise AssertionError


def packed_size(n: int, bits: int) -> int:
    """Bytes for ``n`` codes of width ``bits``: ``ceil(n * bits / 8)``."""
    _check_bits(bits)
    return (n * bits + 7) // 8


def pack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack codes (values < 2**bits) into a 1-D uint8 bitstream of
    ``packed_size(codes.numel(), bits)`` bytes."""
    _check_bits(bits)
    flat = codes.reshape(-1).to(torch.uint8)
    n = flat.numel()
    flat = F.pad(flat, (0, (-n) % _GROUP))
    # (G, 8) codes -> (G, 8, bits) bits -> (G, bits, 8) byte lanes -> bytes
    code_shifts = torch.arange(bits, dtype=torch.uint8, device=flat.device)
    bit_lanes = (flat.reshape(-1, _GROUP)[:, :, None] >> code_shifts) & 1
    byte_shifts = torch.arange(8, dtype=torch.uint8, device=flat.device)
    # torch sums uint8 into int64: cast the words back
    words = (bit_lanes.reshape(-1, bits, 8) << byte_shifts).sum(dim=-1)
    return words.to(torch.uint8).reshape(-1)[:packed_size(n, bits)]


def unpack_bits(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: the first ``n`` codes (uint8).

    ``words`` must hold at least ``packed_size(n, bits)`` bytes (a shorter
    stream would decode its missing tail as zeros) and at most the
    8-code-group-rounded length (a longer one means ``n`` or ``bits``
    disagree with the producer)."""
    _check_bits(bits)
    flat = words.reshape(-1)
    n_groups = (n + _GROUP - 1) // _GROUP
    need = packed_size(n, bits)
    if flat.numel() < need:
        raise ValueError(
            f"unpack_bits: word stream has {flat.numel()} bytes but {n} "
            f"codes at {bits} bits need packed_size = {need}; refusing to "
            f"zero-fill the missing tail")
    if flat.numel() > n_groups * bits:
        raise ValueError(
            f"unpack_bits: word stream has {flat.numel()} bytes but {n} "
            f"codes at {bits} bits occupy at most {n_groups * bits} "
            f"(group-rounded): n/bits disagree with the producer")
    flat = F.pad(flat, (0, n_groups * bits - flat.numel()))
    byte_shifts = torch.arange(8, dtype=torch.uint8, device=flat.device)
    bit_lanes = (flat.reshape(-1, bits)[:, :, None] >> byte_shifts) & 1
    code_shifts = torch.arange(bits, dtype=torch.uint8, device=flat.device)
    codes = (bit_lanes.reshape(-1, 8, bits) << code_shifts).sum(dim=-1)
    return codes.to(torch.uint8).reshape(-1)[:n]
