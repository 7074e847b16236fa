"""Code-slot sizes of the packed wire (port of ``repro/core/packing.py``).

The slice ships power-of-two widths only, whose exact bitstream layout
equals the one-code-per-slot layout the kernels write: code ``i`` of a
byte sits at bit shift ``i * bits``, LSB first.  The cross-byte
bitstream packers for odd widths (``pack_bits`` / ``unpack_bits``) are
ROADMAP queue M, item M8.
"""
from __future__ import annotations

#: Widths the fused kernels pack natively (one code per power-of-two slot).
KERNEL_SLOT_BITS = (1, 2, 4, 8)


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
