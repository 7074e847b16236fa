"""Wrappers of the attention kernels K1 (flash prefill forward) and K8
(paged decode) (port of ``repro/kernels/attention_ops.py``, forward
paths).

For a CUDA tensor a wrapper launches its kernel from
``csrc/flash_fwd.cu`` or ``csrc/decode_paged.cu``, or raises on what the
kernel does not take; for a CPU tensor it runs the plain version in
``attention_ref.py``.  No shape gate or environment variable sends a CUDA
tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import attention_ref, build

HEAD_DIM = 64  # the kernels' compiled head width (q/k and v)
_MAX_G = 16
_MAX_PAGE = 64


def _window_args(window: Optional[int]) -> Tuple[int, int]:
    return (0, 0) if window is None else (1, int(window))


def _check_bf16(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bf16 operands, got {t.dtype}")


def _check_contiguous(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous operands")


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name} operands lie on different devices")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, *,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1.  q: (B, H, Sq, D) pre-scaled; k/v: (B, KH, Skv, D/Dv); qpos
    (Sq[, 1]) and kpos ([1, ]Skv) int32 with the +/-2^30 sentinels.
    Returns (out fp32 (B, H, Sq, Dv), m, l fp32 (B, H, Sq, 1)).

    The CUDA kernel takes any strides whose last axis is contiguous, so
    (B, S, H, D) tensors pass as transposed views without a copy.
    """
    if not q.is_cuda:
        return attention_ref.flash_forward_ref(q, k, v, qpos, kpos,
                                               window=window)
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    _check_bf16("flash_forward", q, k, v)
    _check_device("flash_forward", q, k, v, qpos, kpos)
    if d != HEAD_DIM or v.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_forward is compiled for head_dim "
                         f"{HEAD_DIM}, got q {d}, v {v.shape[-1]}")
    if h % kh or k.shape[:3] != v.shape[:3] or k.shape[0] != b:
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_forward needs {name} with a contiguous "
                             "last axis, 16-byte rows and 16-byte alignment")
    qpos = qpos.reshape(-1).to(torch.int32).contiguous()
    kpos = kpos.reshape(-1).to(torch.int32).contiguous()
    if qpos.numel() != sq or kpos.numel() != skv:
        raise ValueError("qpos / kpos do not match Sq / Skv")
    out = torch.empty((b, sq, h, HEAD_DIM), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    m = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    has_window, win = _window_args(window)
    build.launch(
        "flash_fwd", "flash_fwd_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, kh, sq, skv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], has_window, win,
        build.current_stream())
    return out, m, l


def flash(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          qpos: torch.Tensor, kpos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """(B, S, H, D) operands of ``flash_attention`` -> (B, Sq, H, Dv) in
    qs.dtype (the reference's ``flash_pallas`` forward)."""
    out, _, _ = flash_forward(qs.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), qpos, kpos, window=window)
    return out.transpose(1, 2).to(qs.dtype)


def decode_paged(qf: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, pos_pool: torch.Tensor,
                 page_table: torch.Tensor, qpos: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """K8.  qf: (S, KH, G, D) pre-scaled; pools (P, pg, KH, D/Dv); pos_pool
    (P, pg) int32 (-1 empty); page_table (S, npp) (-1 unallocated); qpos
    (S,) (-1 inactive: the slot's output is 0).  Returns (S, KH, G, Dv)
    fp32.  The kernel reads each slot's pages where they lie in the pool:
    no gathered copy of the cache is made."""
    if not qf.is_cuda:
        return attention_ref.decode_attention_paged_ref(
            qf, k_pool, v_pool, pos_pool, page_table, qpos, window=window)
    s, kh, g, d = qf.shape
    n_pages, pg = k_pool.shape[:2]
    _check_bf16("decode_paged", qf, k_pool, v_pool)
    _check_device("decode_paged", qf, k_pool, v_pool, pos_pool, page_table,
                  qpos)
    if d != HEAD_DIM or k_pool.shape[-1] != HEAD_DIM \
            or v_pool.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode_paged is compiled for head_dim {HEAD_DIM}")
    if k_pool.shape != (n_pages, pg, kh, d) or v_pool.shape != k_pool.shape \
            or pos_pool.shape != (n_pages, pg):
        raise ValueError("pool shapes disagree")
    if g > _MAX_G or pg > _MAX_PAGE:
        raise ValueError(f"decode_paged takes G <= {_MAX_G} and pages of "
                         f"<= {_MAX_PAGE} tokens, got G={g}, pg={pg}")
    if page_table.shape[0] != s or qpos.shape != (s,):
        raise ValueError("page_table / qpos do not match the slot axis")
    if pos_pool.dtype != torch.int32:
        raise TypeError("pos_pool must be int32")
    page_table = page_table.to(torch.int32)
    qpos = qpos.to(torch.int32)
    _check_contiguous("decode_paged", qf, k_pool, v_pool, pos_pool,
                      page_table, qpos)
    out = torch.empty((s, kh, g, HEAD_DIM), dtype=torch.float32,
                      device=qf.device)
    has_window, win = _window_args(window)
    build.launch(
        "decode_paged", "decode_paged_bf16",
        qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), page_table.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), s, kh, g, pg, page_table.shape[1], has_window, win,
        build.current_stream())
    return out
