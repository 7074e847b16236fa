"""``PackedLinear``: a weight matrix stored as packed int codes (port of
``repro/wq/packed.py``).

The serving stacks consume every projection weight the same way,
``x @ p["w*"].to(x.dtype)``, so a weight store only has to meet that one
contract to flow through the unchanged forward and decode code:

* ``codes`` (uint8): the exact ``core.packing`` bitstream of the int
  codes, packed down ``d_in`` *per output column*, so 8 codes of a column
  span exactly ``bits`` whole bytes and a kernel can unpack K tiles;
* fp16 ``scales`` / ``mins``: one affine pair per ``(group, d_out)``;
* ``perm`` (int32) or ``None``: the act-order storage permutation of the
  input channels;
* ``bits``, ``group``, ``d_in``, ``d_out``.

Leading axes of the children are batch (the layer stack):
``models/stack.py`` indexes, unbinds and stacks a store like a tensor.
``to`` is the identity for a dtype (the packed matmul follows the
activation dtype, as ``w.to(x.dtype)`` would) and moves the children for
a device; it never casts the fp16 side info.  ``x @ w`` reaches
``__rmatmul__`` because ``Tensor.__matmul__`` returns ``NotImplemented``
to an operand that is not a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing

__all__ = ["PackedLinear", "pack_weight_codes", "unpack_weight_codes"]

_OCTET = 8  # codes per packing group: 8 codes span exactly `bits` bytes


def pack_weight_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(d_in, d_out) uint8 codes -> (packed_size(d_in, bits), d_out) words.

    Each output column's codes are packed on their own down the input axis
    (the exact ``core.packing.pack_bits`` stream per column).  All columns
    go through one ``pack_bits`` call: padded to whole octets, a column's
    stream is ``nb * bits`` bytes and the columns' streams lie end to end.
    """
    d_in, d_out = codes.shape
    nb = -(-d_in // _OCTET)
    cols = F.pad(codes.to(torch.uint8).T, (0, nb * _OCTET - d_in))
    words = packing.pack_bits(cols, bits).reshape(d_out, nb * bits)
    return words[:, :packing.packed_size(d_in, bits)].T.contiguous()


def unpack_weight_codes(words: torch.Tensor, bits: int,
                        d_in: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight_codes`: -> (d_in, d_out) uint8."""
    rows, d_out = words.shape
    if rows != packing.packed_size(d_in, bits):
        raise ValueError(f"{rows} packed rows do not hold {d_in} codes of "
                         f"{bits} bits")
    nb = -(-d_in // _OCTET)
    cols = F.pad(words.T, (0, nb * bits - rows))
    codes = packing.unpack_bits(cols, bits, d_out * nb * _OCTET)
    return codes.reshape(d_out, nb * _OCTET)[:, :d_in].T.contiguous()


@dataclasses.dataclass
class PackedLinear:
    """A ``(..., d_in, d_out)`` weight matrix served as packed int codes.

    ``w_hat[perm[r], c] = codes[r, c] * scales[r // group, c] +
    mins[r // group, c]`` (``perm`` the identity when ``None``).  Matmul is
    defined on the unstacked (2-D) form only; the stack executor hands each
    layer its own slice.
    """

    codes: torch.Tensor            # (*batch, packed_rows, d_out) uint8
    scales: torch.Tensor           # (*batch, n_groups, d_out) fp16
    mins: torch.Tensor             # (*batch, n_groups, d_out) fp16
    perm: Optional[torch.Tensor]   # (*batch, d_in) int32, or None
    bits: int
    group: int
    d_in: int
    d_out: int

    def _children(self) -> Tuple[Optional[torch.Tensor], ...]:
        return self.codes, self.scales, self.mins, self.perm

    def map_children(self, fn) -> "PackedLinear":
        """The same store with ``fn`` applied to each present child."""
        codes, scales, mins, perm = (None if c is None else fn(c)
                                     for c in self._children())
        return dataclasses.replace(self, codes=codes, scales=scales,
                                   mins=mins, perm=perm)

    # -- the array-like surface the forward code touches -----------------
    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.codes.shape[:-2])

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.batch_shape + (self.d_in, self.d_out)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to(self, target) -> "PackedLinear":
        """Identity for a dtype; for a device, the children moved there."""
        if isinstance(target, torch.dtype):
            return self
        return self.map_children(lambda c: c.to(target))

    def __rmatmul__(self, x):
        from repro_torch.wq import ops
        return ops.wq_matmul(x, self)

    def __matmul__(self, other):
        raise TypeError("PackedLinear is an x @ w weight store; w @ x is "
                        "not supported")

    # -- the layer axis --------------------------------------------------
    def __getitem__(self, i: int) -> "PackedLinear":
        """Layer ``i`` of a stacked store (views, no copies)."""
        if not self.batch_shape:
            raise IndexError("indexing an unstacked PackedLinear")
        return self.map_children(lambda c: c[i])

    def unbind(self) -> List["PackedLinear"]:
        """The per-layer stores of the leading axis (views)."""
        return [self[i] for i in range(self.batch_shape[0])]

    @classmethod
    def stack(cls, stores: List["PackedLinear"]) -> "PackedLinear":
        """Stack same-layout stores on a new leading axis."""
        first = stores[0]
        if any((s.perm is None) != (first.perm is None)
               or (s.bits, s.group, s.d_in, s.d_out)
               != (first.bits, first.group, first.d_in, first.d_out)
               for s in stores):
            raise ValueError("stacking PackedLinear stores of different "
                             "layouts")
        return dataclasses.replace(
            first, **{name: None if getattr(first, name) is None
                      else torch.stack([getattr(s, name) for s in stores])
                      for name in ("codes", "scales", "mins", "perm")})

    # -- introspection ---------------------------------------------------
    def packed_bytes(self) -> int:
        """Physical weight-store bytes (codes, scales, mins and perm)."""
        return sum(c.numel() * c.element_size() for c in self._children()
                   if c is not None)

    def dequantize(self) -> torch.Tensor:
        """fp32 ``(..., d_in, d_out)`` in the ORIGINAL input-channel order.

        Test and debug path: it materialises the dense matrix the packed
        store exists to avoid.
        """
        if self.batch_shape:
            return torch.stack([s.dequantize() for s in self.unbind()])
        codes = unpack_weight_codes(self.codes, self.bits, self.d_in)
        n_groups = self.scales.shape[-2]
        cf = F.pad(codes.float(), (0, 0, 0, n_groups * self.group - self.d_in))
        cf = cf.reshape(n_groups, self.group, self.d_out)
        w = cf * self.scales.float()[:, None, :] \
            + self.mins.float()[:, None, :]
        w = w.reshape(n_groups * self.group, self.d_out)[:self.d_in]
        if self.perm is None:
            return w
        out = torch.empty_like(w)
        out[self.perm.long()] = w
        return out
