"""Wrapper of the packed dequant-matmul K12 (``csrc/wq.cu``), the port of
``repro/kernels/wq_kernel.py::matmul_pallas``.

``wq/ops.py::wq_matmul`` sends a CUDA tensor here and a CPU tensor to the
plain version, ``kernels/ref.py::wq_matmul_ref``.  The reference wrapper
pads M, N and K to its tiles; the CUDA kernel masks its ragged tiles
itself, so no padded copy is made.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import packed_size
from repro_torch.kernels import build

WQ_BITS = (2, 3, 4)  # 8 codes of <= 4 bits fill one 32-bit word
_MAX_ROWS = 65535 * 64  # grid.y of the launch times its 64-row tile
_FN = {torch.bfloat16: "wq_matmul_bf16", torch.float32: "wq_matmul_f32"}


def wq_matmul_kernel(x2d: torch.Tensor, words: torch.Tensor,
                     scales: torch.Tensor, mins: torch.Tensor, *, bits: int,
                     group: int, d_in: int) -> torch.Tensor:
    """K12 launch: x2d (M, d_in) bf16 / fp32 CUDA @ the packed (d_in,
    d_out) weight -> (M, d_out) fp32.  ``words`` (packed_size(d_in, bits),
    d_out) uint8 in storage channel order, ``scales`` / ``mins``
    (ceil(d_in / group), d_out) fp16."""
    if bits not in WQ_BITS:
        raise ValueError(f"K12 takes bits in {WQ_BITS}, got {bits}")
    if group <= 0 or group % 8:
        raise ValueError(f"K12 takes a group that is a positive multiple "
                         f"of 8, got {group}")
    tensors = (x2d, words, scales, mins)
    if not x2d.is_cuda or any(t.device != x2d.device for t in tensors):
        raise ValueError("K12 operands must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K12 takes contiguous operands")
    if x2d.dtype not in _FN:
        raise TypeError(f"K12 reads bf16 or fp32 activations, got "
                        f"{x2d.dtype}")
    m, k = x2d.shape
    d_out = words.shape[1]
    n_groups = -(-d_in // group)
    if k != d_in or not 0 < m <= _MAX_ROWS:
        raise ValueError(f"x {tuple(x2d.shape)} for d_in {d_in}: K12 takes "
                         f"1..{_MAX_ROWS} rows of d_in")
    if words.dtype != torch.uint8 or \
            words.shape != (packed_size(d_in, bits), d_out):
        raise ValueError("words do not hold d_in codes per column")
    if any(t.dtype != torch.float16 or t.shape != (n_groups, d_out)
           for t in (scales, mins)):
        raise ValueError(f"K12 takes ({n_groups}, {d_out}) fp16 scales "
                         "and mins")
    out = torch.empty((m, d_out), dtype=torch.float32, device=x2d.device)
    build.launch("wq_matmul", _FN[x2d.dtype], x2d.data_ptr(),
                 words.data_ptr(), scales.data_ptr(), mins.data_ptr(),
                 out.data_ptr(), m, d_in, d_out, bits, group,
                 build.current_stream())
    return out
