"""Plain PyTorch versions of the attention kernels K1, K2 / K3 and K8
(port of ``repro/kernels/attention_ref.py``: ``flash_reference`` forward
and backward, and the paged decode reference).

``kernels/attention_ops.py`` runs these on CPU tensors; on the card they
are what the CUDA kernels are held against.  Scores and sums are fp32
(fp64 for fp64 operands, so that ``gradcheck`` can hold them); the
probabilities and dS are rounded to the operand dtype before their
products, as in the reference.

One deliberate difference from the reference's online softmax: a masked
score contributes exactly 0 to the row sum.  The reference (and its TPU
kernel) lets a row that has seen no visible key yet add exp(0) = 1 per
masked score, which later visible keys wash out; for a row that never
sees a key (a padded query row) its (out, m, l) then depend on the block
size.  Here such a row gives out = 0, m = -1e30, l = 0 whatever the
tiling, which is what the CUDA kernel computes too.  Rows with at least
one visible key agree with the reference.  The backward follows: a
masked entry of P is exactly 0, where the reference gives exp(-1e30 -
(-1e30)) = 1 on a row that saw no key.  That matters only where such a
row's output gradient is non-zero, which ``flash_attention`` never
produces, because it slices those rows off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
FAR = 2 ** 30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) visibility from runtime positions: causal and in-window."""
    qp = qpos.reshape(-1, 1).long()
    kp = kpos.reshape(1, -1).long()
    m = kp <= qp
    if window is not None:
        m &= qp - kp < window
    return m


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation dtype: fp64 stays fp64, the rest fp32."""
    return t if t.dtype == torch.float64 else t.float()


def flash_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qpos: torch.Tensor, kpos: torch.Tensor, *,
                      window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention forward with the TPU kernel's contract.

    q: (B, H, Sq, D) pre-scaled; k/v: (B, KH, Skv, D/Dv); qpos (Sq[, 1]),
    kpos ([1, ]Skv) int32 carrying the +/-2^30 sentinels of padding and
    ``kv_valid_len``.  Returns (out fp32 (B, H, Sq, Dv), m, l fp32
    (B, H, Sq, 1)); out = acc / max(l, 1e-30).
    """
    g = q.shape[1] // k.shape[1]
    kx = _acc(k.repeat_interleave(g, dim=1))
    vx = v.repeat_interleave(g, dim=1)
    s = _acc(q) @ kx.transpose(-1, -2)
    mask = _mask(qpos, kpos, window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = (_acc(p.to(v.dtype)) @ _acc(vx)) / torch.clamp_min(l, 1e-30)
    return out, m, l


def flash_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       go: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                       di: torch.Tensor, qpos: torch.Tensor,
                       kpos: torch.Tensor, *, window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward with the contract of the TPU kernels
    ``backward_dq`` / ``backward_dkv`` together (K2 and K3).

    Operands as ``flash_forward_ref``, plus go (B, H, Sq, Dv) and the
    forward's m, l and di = rowsum(go * out), all (B, H, Sq, 1) fp32.
    Returns dq (B, H, Sq, D) w.r.t. the pre-scaled q, and dk / dv
    (B, KH, Skv, D/Dv) summed over the GQA group, all fp32:
    P = exp(S - m) / max(l, 1e-30), dP = go V^T, dS = P (dP - di),
    dq = dS K, dk = dS^T q, dv = P^T go.
    """
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    kx = _acc(k.repeat_interleave(g, dim=1))
    vx = _acc(v.repeat_interleave(g, dim=1))
    s = _acc(q) @ kx.transpose(-1, -2)
    mask = _mask(qpos, kpos, window)
    s = torch.where(mask, s, NEG_INF)
    linv = 1.0 / torch.clamp_min(l, 1e-30)
    p = torch.where(mask, torch.exp(s - m) * linv, 0.0)
    dp = _acc(go) @ vx.transpose(-1, -2)
    ds = p * (dp - di)
    dq = _acc(ds.to(k.dtype)) @ kx
    dk = _acc(ds.to(q.dtype)).transpose(-1, -2) @ _acc(q)
    dv = _acc(p.to(go.dtype)).transpose(-1, -2) @ _acc(go)
    dk = dk.reshape(b, kh, g, skv, d).sum(dim=2)
    dv = dv.reshape(b, kh, g, skv, dv.shape[-1]).sum(dim=2)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def decode_attention_ref(qf, k_cache, v_cache, kpos, qpos, *, window=None):
    """Single-token attention against a contiguous cache.

    qf: (B, KH, G, D) pre-scaled grouped query; caches (B, L, KH, D/Dv);
    kpos (B, L) absolute position of each slot (-1 empty); qpos (B,).
    Returns (B, KH, G, Dv) fp32.
    """
    s = torch.einsum("bkgd,bskd->bkgs", qf.float(), k_cache.float())
    valid = (kpos >= 0) & (kpos <= qpos[:, None])
    if window is not None:
        valid &= qpos[:, None] - kpos < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                        v_cache.float())


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P, pg, ...) pool + (S, npp) table -> (S, npp * pg, ...) view.

    Unallocated (-1) entries are clamped to page 0; ``paged_kpos`` masks
    them out."""
    g = pool[torch.clamp_min(page_table, 0).long()]  # (S, npp, pg, ...)
    s, npp, pg = g.shape[:3]
    return g.reshape((s, npp * pg) + tuple(g.shape[3:]))


def paged_kpos(pos_pool: torch.Tensor, page_table: torch.Tensor
               ) -> torch.Tensor:
    """Gathered (S, L) key positions, -1 on unallocated pages."""
    kpos = gather_pages(pos_pool, page_table)
    alloc = torch.repeat_interleave(page_table >= 0, pos_pool.shape[1],
                                    dim=1)
    return torch.where(alloc, kpos, -1)


def _zero_fully_masked(out, kpos, qpos, window):
    """Slots with no visible key (inactive, qpos = -1) return exactly 0."""
    valid = (kpos >= 0) & (kpos <= qpos[:, None])
    if window is not None:
        valid &= qpos[:, None] - kpos < window
    any_valid = valid.any(dim=-1)
    return torch.where(any_valid[:, None, None, None], out, 0.0)


def decode_attention_paged_ref(qf, k_pool, v_pool, pos_pool, page_table,
                               qpos, *, window=None):
    """Single-token attention against a paged KV pool.

    qf: (S, KH, G, D) pre-scaled; pools (P, pg, KH, D/Dv); pos_pool
    (P, pg) (-1 empty); page_table (S, npp) (-1 unallocated); qpos (S,)
    (-1 inactive).  Returns (S, KH, G, Dv) fp32.
    """
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    kpos = paged_kpos(pos_pool, page_table)
    out = decode_attention_ref(qf, k, v, kpos, qpos, window=window)
    return _zero_fully_masked(out, kpos, qpos, window)
