"""Wrapper of the packed dequant-matmul K12 (``csrc/wq.cu``), the port of
``repro/kernels/wq_kernel.py::matmul_pallas``.

``wq/ops.py::wq_matmul`` sends a CUDA tensor here and a CPU tensor to the
plain version, ``kernels/ref.py::wq_matmul_ref``.  The reference wrapper
pads M, N and K to its tiles; the CUDA kernels mask their ragged tiles
themselves (TMA fills what lies past an edge with zeros), so no padded copy
is made.

bf16 activations take one of two kernels, picked by :func:`variant`:

* ``"gemv"`` for M <= 16 (decode ticks, generate steps) and for any shape
  the TMA tensor maps cannot describe: K split across a cluster of blocks
  and the warps of each (:func:`gemv_plan`), with the act-order gather
  read inside the kernel (``perm``);
* ``"wgmma"`` for larger M with d_in % 64 == 0 and d_out % 16 == 0
  (prefill): TMA-fed ``wgmma``, after one ``index_select`` of x for an
  act-order store.

Both return bf16.  fp32 activations take the FFMA tile kernel and return
fp32, after the same ``index_select`` for an act-order store.  Every call
counts one ``wq_matmul`` launch, whatever the variant.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.packing import packed_size
from repro_torch.kernels import build

WQ_BITS = (2, 3, 4)  # 8 codes of <= 4 bits fill one 32-bit word
SMS = 132  # the H100 SXM's streaming multiprocessors
GEMV_MAX_M = 16  # above this (and a TMA-mappable shape) the wgmma kernel
GEMV_COLS = 32  # columns per GEMV block: 8 lane groups x 4
GEMV_ROWS = 16  # rows of x per GEMV block: the mma's 16
GEMV_MAX_SPLITS = 8  # GEMV blocks per cluster at most, each a slice of K
GEMV_WARPS = 4  # warps per GEMV block, each a range of its slice
_MAX_ROWS = 65535 * 64  # grid.y of the fp32 launch times its 64-row tile


def variant(m: int, d_in: int, d_out: int) -> str:
    """Which bf16 kernel K12 launches for (m, d_in) @ (d_in, d_out)."""
    if m > GEMV_MAX_M and d_in % 64 == 0 and d_out % 16 == 0:
        return "wgmma"
    return "gemv"


@functools.lru_cache(maxsize=None)
def gemv_plan(m: int, d_in: int,
              d_out: int) -> Tuple[int, int, int, int, int]:
    """(column tiles, row chunks, splits, k16 steps per split, per warp) of
    the GEMV: clusters of ``splits`` blocks (up to ``GEMV_MAX_SPLITS``, each
    with at least one k16 step) over ``GEMV_COLS`` columns and
    ``GEMV_ROWS`` rows of x.  Block ks of a cluster takes the k16 steps
    [ks sps, (ks + 1) sps) of the ceil(d_in / 16), its warp w the steps
    [w spw, (w + 1) spw) of those: together they cover K exactly once."""
    steps = -(-d_in // 16)
    sps = -(-steps // min(GEMV_MAX_SPLITS, steps))
    return (-(-d_out // GEMV_COLS), -(-m // GEMV_ROWS), -(-steps // sps),
            sps, -(-sps // GEMV_WARPS))


GEMV_SMEM_MAX = 227 * 1024  # shared memory a block may use


@functools.lru_cache(maxsize=None)
def gemv_smem_bytes(m: int, d_in: int, d_out: int, bits: int,
                    group: int) -> int:
    """Shared memory of one GEMV block (``csrc/wq.cu::GemvSmem``): its K
    slice of the words, scales and mins of its columns, its rows of x in
    bf16 and the warps' partial sums."""
    _, _, _, sps, _ = gemv_plan(m, d_in, d_out)
    rows = min(m, GEMV_ROWS)
    g_rows = -(-sps * 16 // group) + 1
    return (sps * 2 * bits * GEMV_COLS + 2 * g_rows * GEMV_COLS * 2
            + -(-rows * (sps * 16 + 8) * 2 // 16) * 16
            + GEMV_WARPS * GEMV_ROWS * GEMV_COLS * 4)


WGMMA_COLS = 128  # output columns per wgmma block: two warpgroups' m64


@functools.lru_cache(maxsize=None)
def wgmma_tokens(m: int, d_out: int) -> int:
    """Rows of x per wgmma block: 256 while that still gives three quarters
    of the 132 SMs a block (one block per SM at 256), else 128 while half
    of them get one (two blocks per SM), else 64."""
    cols = -(-d_out // WGMMA_COLS)
    if 4 * cols * -(-m // 256) >= 3 * SMS:
        return 256
    return 128 if 2 * cols * -(-m // 128) >= SMS else 64


def _check(x2d, words, scales, mins, perm, bits, group, d_in):
    """K12's checks of its operands: the layout first, the device last."""
    if bits not in WQ_BITS:
        raise ValueError(f"K12 takes bits in {WQ_BITS}, got {bits}")
    if group <= 0 or group % 8:
        raise ValueError(f"K12 takes a group that is a positive multiple "
                         f"of 8, got {group}")
    if x2d.dtype not in (torch.bfloat16, torch.float32):
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
    if scales.dtype != torch.float16 or mins.dtype != torch.float16 \
            or scales.shape != (n_groups, d_out) \
            or mins.shape != (n_groups, d_out):
        raise ValueError(f"K12 takes ({n_groups}, {d_out}) fp16 scales "
                         "and mins")
    if perm is not None and (perm.dtype != torch.int32
                             or perm.shape != (d_in,)):
        raise ValueError(f"K12 takes perm as ({d_in},) int32, got "
                         f"{tuple(perm.shape)} {perm.dtype}")
    # plain conditions, no generators: this runs 112 times a decode tick
    if not (x2d.is_contiguous() and words.is_contiguous()
            and scales.is_contiguous() and mins.is_contiguous()
            and (perm is None or perm.is_contiguous())):
        raise ValueError("K12 takes contiguous operands")
    dev = x2d.get_device() if x2d.is_cuda else -1
    if dev < 0 or words.get_device() != dev or scales.get_device() != dev \
            or mins.get_device() != dev \
            or (perm is not None and perm.get_device() != dev):
        raise ValueError("K12 operands must lie on one CUDA device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its address is not 16-byte aligned (a
    TMA base must be)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wq_matmul_kernel(x2d: torch.Tensor, words: torch.Tensor,
                     scales: torch.Tensor, mins: torch.Tensor, *, bits: int,
                     group: int, d_in: int,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12 launch: x2d (M, d_in) bf16 / fp32 CUDA @ the packed (d_in,
    d_out) weight -> (M, d_out) in x2d's dtype.  ``words``
    (packed_size(d_in, bits), d_out) uint8 in storage channel order,
    ``scales`` / ``mins`` (ceil(d_in / group), d_out) fp16; ``perm`` (d_in,)
    int32, the act-order storage permutation (x is read as
    x[:, perm]), or None."""
    _check(x2d, words, scales, mins, perm, bits, group, d_in)
    m = x2d.shape[0]
    d_out = words.shape[1]
    out = torch.empty((m, d_out), dtype=x2d.dtype, device=x2d.device)
    stream = build.current_stream(x2d.get_device())
    kind = variant(m, d_in, d_out) if x2d.dtype == torch.bfloat16 else "f32"
    if kind == "gemv":
        if gemv_smem_bytes(m, d_in, d_out, bits, group) > GEMV_SMEM_MAX:
            raise ValueError(f"K12's GEMV keeps a block's slice of the store "
                             f"and x in shared memory: d_in {d_in} is too "
                             "long")
        _, _, splits, sps, spw = gemv_plan(m, d_in, d_out)
        build.launch("wq_matmul", "wq_matmul_bf16_gemv", x2d.data_ptr(),
                     None if perm is None else perm.data_ptr(),
                     words.data_ptr(), scales.data_ptr(), mins.data_ptr(),
                     out.data_ptr(), m, d_in, d_out, bits, group, splits,
                     sps, spw,
                     stream)
        return out
    if perm is not None:
        x2d = torch.index_select(x2d, 1, perm)
    if kind == "wgmma":
        x2d, words, scales, mins = (_aligned(t)
                                    for t in (x2d, words, scales, mins))
        build.launch("wq_matmul", "wq_matmul_bf16_wgmma", x2d.data_ptr(),
                     words.data_ptr(), scales.data_ptr(), mins.data_ptr(),
                     out.data_ptr(), m, d_in, d_out, bits, group,
                     wgmma_tokens(m, d_out), stream)
        return out
    build.launch("wq_matmul", "wq_matmul_f32", x2d.data_ptr(),
                 words.data_ptr(), scales.data_ptr(), mins.data_ptr(),
                 out.data_ptr(), m, d_in, d_out, bits, group, stream)
    return out


