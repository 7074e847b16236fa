"""The packed dequant-matmul ``x @ w`` of a :class:`PackedLinear` (port of
``repro/wq/ops.py``).

A CUDA tensor goes to the kernel K12 (``kernels/wq_ops.py``), a CPU tensor
to its plain version (``kernels/ref.py::wq_matmul_ref``).  There is no
``impl=`` switch and no environment variable: the device decides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import wq_matmul_ref
from repro_torch.kernels.wq_ops import wq_matmul_kernel

__all__ = ["wq_matmul"]


def wq_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a :class:`~repro_torch.wq.packed.PackedLinear` ``w``.

    ``x``: (..., d_in) activations; returns (..., d_out) in ``x.dtype``
    (fp32 accumulation on both paths, rounded once to ``x.dtype``).  A
    stacked store must be sliced to its 2-D per-layer form first (the
    stack executor does).
    """
    build.refuse_dtensor("wq_matmul", x, w.codes, w.scales, w.mins)
    if w.codes.ndim != 2:
        raise ValueError(
            "matmul on a layer-stacked PackedLinear: slice the stack "
            f"(codes ndim {w.codes.ndim}) to one layer first")
    if x.shape[-1] != w.d_in:
        raise ValueError(f"x feature dim {x.shape[-1]} != d_in {w.d_in}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, w.d_in).contiguous()
    kw = dict(bits=w.bits, group=w.group, d_in=w.d_in)
    if x2.is_cuda:
        # K12 reads the act-order gather itself and writes x.dtype
        y = wq_matmul_kernel(x2, w.codes, w.scales, w.mins, perm=w.perm,
                             **kw)
    else:
        if w.perm is not None:
            # act-order: gather the activations into the storage order
            x2 = torch.index_select(x2, -1, w.perm)
        y = wq_matmul_ref(x2, w.codes, w.scales, w.mins, **kw).to(x.dtype)
    return y.reshape(lead + (w.d_out,))
