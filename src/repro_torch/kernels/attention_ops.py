"""Wrappers of the attention kernels K1 (flash forward), K2 / K3 (flash
backward) and K8 (paged decode) (port of ``repro/kernels/attention_ops.py``:
``flash_pallas`` with its custom VJP, and ``decode_paged_pallas``).

For a CUDA tensor a wrapper launches its kernel from ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` or ``csrc/decode_paged.cu``, or raises on what the
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


def _check_flash(name: str, q, k, v, qpos, kpos, *rest):
    """The checks every flash kernel makes of its operands (``rest``: the
    bf16 (B, H, Sq, Dv) output gradient, if any).  Returns (qpos, kpos)
    as flat contiguous int32."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    _check_bf16(name, q, k, v, *rest)
    _check_device(name, q, k, v, qpos, kpos, *rest)
    if d != HEAD_DIM or v.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name} is compiled for head_dim {HEAD_DIM}, got "
                         f"q {d}, v {v.shape[-1]}")
    if h % kh or k.shape[:3] != v.shape[:3] or k.shape[0] != b \
            or any(t.shape != (b, h, sq, HEAD_DIM) for t in rest):
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for i, t in enumerate((q, k, v) + rest):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs operand {i} with a contiguous "
                             "last axis, 16-byte rows and 16-byte alignment")
    qpos = qpos.reshape(-1).to(torch.int32).contiguous()
    kpos = kpos.reshape(-1).to(torch.int32).contiguous()
    if qpos.numel() != sq or kpos.numel() != skv:
        raise ValueError("qpos / kpos do not match Sq / Skv")
    return qpos, kpos


def _row_stats(name: str, like: torch.Tensor, *stats: torch.Tensor):
    """m, l, di as contiguous fp32 (B, H, Sq, 1) on ``like``'s device."""
    out = []
    for t in stats:
        if t.dtype != torch.float32 or t.device != like.device \
                or t.shape != like.shape[:3] + (1,):
            raise ValueError(f"{name} takes fp32 (B, H, Sq, 1) row stats")
        out.append(t.contiguous())
    return out


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
    b, h, sq, _ = q.shape
    kh, skv = k.shape[1], k.shape[2]
    qpos, kpos = _check_flash("flash_forward", q, k, v, qpos, kpos)
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


def flash_backward_dq(q, k, v, go, m, l, di, qpos, kpos, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """K2.  Operands as ``flash_forward`` plus go (B, H, Sq, Dv) and the
    forward's m, l and di = rowsum(go * out) (B, H, Sq, 1) fp32.  Returns
    dq fp32 (B, H, Sq, D) w.r.t. the pre-scaled query, as a transposed
    view of a (B, Sq, H, D) buffer."""
    if not q.is_cuda:
        return attention_ref.flash_backward_ref(
            q, k, v, go, m, l, di, qpos, kpos, window=window)[0]
    b, h, sq, _ = q.shape
    kh, skv = k.shape[1], k.shape[2]
    qpos, kpos = _check_flash("flash_backward_dq", q, k, v, qpos, kpos, go)
    m, l, di = _row_stats("flash_backward_dq", q, m, l, di)
    dq = torch.empty((b, sq, h, HEAD_DIM), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    has_window, win = _window_args(window)
    build.launch(
        "flash_bwd_dq", "flash_bwd_dq_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), dq.data_ptr(), b, h, kh, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *go.stride()[:3], *dq.stride()[:3], has_window, win,
        build.current_stream())
    return dq


def flash_backward_dkv(q, k, v, go, m, l, di, qpos, kpos, *,
                       window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3.  Operands as ``flash_backward_dq``.  Returns (dk, dv) fp32
    (B, KH, Skv, D/Dv), each summed over the GQA group, as transposed
    views of (B, Skv, KH, D) buffers."""
    if not q.is_cuda:
        _, dk, dv = attention_ref.flash_backward_ref(
            q, k, v, go, m, l, di, qpos, kpos, window=window)
        return dk, dv
    b, h, sq, _ = q.shape
    kh, skv = k.shape[1], k.shape[2]
    qpos, kpos = _check_flash("flash_backward_dkv", q, k, v, qpos, kpos, go)
    m, l, di = _row_stats("flash_backward_dkv", q, m, l, di)
    dk = torch.empty((b, skv, kh, HEAD_DIM), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    has_window, win = _window_args(window)
    build.launch(
        "flash_bwd_dkv", "flash_bwd_dkv_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kh, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *go.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], has_window,
        win, build.current_stream())
    return dk, dv


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) <-> (B, H, S, D), a view."""
    return x.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """The port's ``flash_pallas``: flash attention on pre-scaled,
    chunk-padded (B, S, H, D) operands, whose backward runs K2 and K3.

    The forward runs K1 and saves (q, k, v, qpos, kpos, out, m, l), with
    ``out`` already in q's dtype, as the reference's custom VJP does.  The
    backward forms di = rowsum(dO * O) in fp32 (fp64 for fp64 operands)
    outside the kernels and returns dq / dk / dv in q / k / v's dtypes.
    """

    @staticmethod
    def forward(ctx, qs, k, v, qpos, kpos, window):
        out, m, l = flash_forward(_bhsd(qs), _bhsd(k), _bhsd(v), qpos, kpos,
                                  window=window)
        out = _bhsd(out).to(qs.dtype)
        ctx.save_for_backward(qs, k, v, qpos, kpos, out, m, l)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, gout):
        qs, k, v, qpos, kpos, out, m, l = ctx.saved_tensors
        gout = gout.contiguous()  # autograd may hand a strided view
        acc = torch.float64 if qs.dtype == torch.float64 else torch.float32
        di = torch.einsum("bshd,bshd->bhs", gout.to(acc),
                          out.to(acc)).unsqueeze(-1)
        args = (_bhsd(qs), _bhsd(k), _bhsd(v), _bhsd(gout), m, l, di, qpos,
                kpos)
        dq = flash_backward_dq(*args, window=ctx.window)
        dk, dv = flash_backward_dkv(*args, window=ctx.window)
        return (_bhsd(dq).to(qs.dtype), _bhsd(dk).to(k.dtype),
                _bhsd(dv).to(v.dtype), None, None, None)


def flash(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          qpos: torch.Tensor, kpos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """(B, S, H, D) operands of ``flash_attention`` -> (B, Sq, H, Dv) in
    qs.dtype, differentiable in (qs, k, v) through K2 / K3."""
    return FlashAttention.apply(qs, k, v, qpos, kpos, window)


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
