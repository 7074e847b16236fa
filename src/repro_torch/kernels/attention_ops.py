"""Wrappers of the attention kernels K1 (flash forward), K2 / K3 (flash
backward), K6 / K7 (ring-cache decode, bf16 / int8) and K8 / K9 (paged
decode, bf16 / int8) (port of ``repro/kernels/attention_ops.py``:
``flash_pallas`` with its custom VJP, ``decode_pallas``,
``decode_q8_pallas``, ``decode_paged_pallas`` and
``decode_paged_q8_pallas``).

For a CUDA tensor a wrapper launches its kernel from ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` or ``csrc/decode_paged.cu``, or raises on what the
kernel does not take; for a CPU tensor it runs the plain version in
``attention_ref.py``.  No shape gate or environment variable sends a CUDA
tensor to the plain version.

The four decode kernels are one kernel body (``csrc/decode_paged.cu``)
with one launch plan, ``decode_paged_plan``: a thread-block cluster per
(row, kv head) whose ranks split the row's pages.  K8 / K9 take the pages
of a slot's table row; K6 / K7 take a ring row as ``ceil(L / RING_PAGE)``
virtual pages, the last one ragged.  The reference's ring wrappers fall
back to jnp where no block divides the cache length; K6 / K7 take any
length whose plan fits a block's shared memory.  The decode kernels are
compiled for head widths ``DECODE_HEAD_DIMS`` (64, 128 and zamba2_2_7b's
80), the flash kernels for the (D, Dv) pairs ``FLASH_HEAD_DIMS`` (q/k width
D, v width Dv: (96, 64) is MLA's on minicpm3_4b, (192, 128) on
deepseek_v2_236b, (80, 80) zamba2_2_7b's); the wrappers raise on any other
width.  A width of 80 is kept 96 columns wide in the flash kernels' shared
memory (``padded``) and 88 wide in a bf16 decode round buffer
(``decode_row``), and the plans count those bytes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import attention_ref, build

# the decode kernels' compiled widths, D = Dv
DECODE_HEAD_DIMS = (64, 128, 80)
# the flash kernels' compiled (D, Dv) pairs
FLASH_HEAD_DIMS = ((64, 64), (128, 128), (96, 64), (192, 128), (80, 80))
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


def _check_widths(name: str, d: int, dv: int) -> None:
    """Raise unless (D, Dv) is a compiled pair."""
    if (d, dv) not in FLASH_HEAD_DIMS:
        raise ValueError(
            f"{name} is compiled for head_dim (D, Dv) in {FLASH_HEAD_DIMS}, "
            f"got ({d}, {dv}) (a width no ROADMAP item queues)")


def padded(w: int) -> int:
    """The columns a flash kernel keeps of a W-wide operand, in shared
    memory and in its accumulators: W rounded up to 32 (80 -> 96; the
    tensor maps' zeros fill the rest, csrc/flash_common.cuh)."""
    return -(-w // 32) * 32


def _check_flash(name: str, q, k, v, qpos, kpos, *rest):
    """The checks every flash kernel makes of its operands (``rest``: the
    bf16 (B, H, Sq, Dv) output gradient, if any).  Returns (qpos, kpos)
    as flat contiguous int32."""
    b, h, sq, d = q.shape
    kh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    _check_bf16(name, q, k, v, *rest)
    _check_device(name, q, k, v, qpos, kpos, *rest)
    if k.shape[-1] != d:
        raise ValueError(f"{name}: q and k head_dim differ, q {d}, k "
                         f"{k.shape[-1]}")
    _check_widths(name, d, dv)
    if h % kh or k.shape[:3] != v.shape[:3] or k.shape[0] != b \
            or any(t.shape != (b, h, sq, dv) for t in rest):
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
    build.refuse_dtensor("flash_forward", q, k, v, qpos, kpos)
    if not q.is_cuda:
        return attention_ref.flash_forward_ref(q, k, v, qpos, kpos,
                                               window=window)
    b, h, sq, d = q.shape
    kh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    qpos, kpos = _check_flash("flash_forward", q, k, v, qpos, kpos)
    out = torch.empty((b, sq, h, dv), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    m = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    has_window, win = _window_args(window)
    build.launch(
        "flash_fwd", "flash_fwd_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, kh, sq, skv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], has_window, win, d, dv,
        build.current_stream())
    return out, m, l


# K2 / K3 launch geometry (csrc/flash_bwd.cu): K2 takes q tiles of 128
# rows against kv tiles of 64 keys, K3 kv tiles of 128 keys against q tiles
# of 64 rows; both keep a ring of 3 stages.  K2 keeps two Q / dO slots, but
# only 2 stages where D + Dv passes BWD_DQ_WIDE (at (128, 128)); past
# BWD_SPLIT (at (192, 128)) K2 keeps one slot and 3 stages, and K3's two
# warpgroups split the dK / dV columns of one kv tile of BWD_SPLIT_KEYS
BWD_DQ_ROWS, BWD_DQ_KEYS = 128, 64
BWD_DKV_KEYS, BWD_DKV_ROWS = 128, 64
BWD_STAGES = 3
BWD_DQ_WIDE = 192
BWD_SPLIT, BWD_SPLIT_KEYS = 256, 64
BWD_MAX_CLUSTER = 8  # portable thread block cluster size
SMS = 132  # the H100 SXM's streaming multiprocessors
SMEM_MAX = 232448  # dynamic shared memory a block may use on the H100


class LaunchPlan(NamedTuple):
    """One kernel's launch: ``grid`` (x, y); blocks in clusters of
    ``cluster`` along x; ``tiles[y]`` the tile that grid row y takes (in
    launch order, longest first); ``heads[r]`` the heads of its GQA group
    that cluster rank r sweeps, in order, relative to the block's first;
    ``smem`` the dynamic shared-memory bytes of a block."""
    grid: Tuple[int, int]
    cluster: int
    tiles: Tuple[int, ...]
    heads: Tuple[Tuple[int, ...], ...]
    smem: int


def bwd_heads_per_block(g: int, b: int, h: int, n: int,
                        max_cluster: Optional[int] = None) -> int:
    """How many of a group's G query heads one block of K2 / K3 sweeps in
    turn: the most (a divisor p of G) whose sweep, p n tiles for the longest
    block (n tiles of 64 positions on the swept axis), stays within the
    causal work per SM, B H n^2 / (4 SMS) tiles.  More heads per block
    means fewer blocks paying a block's fixed cost (its visible-tile list,
    first loads, epilogue); the bound keeps the longest block from setting
    the kernel's time.  With ``max_cluster`` (K3, whose G / p blocks of a
    group form a cluster) p is at least G / max_cluster."""
    divisors = [p for p in range(1, g + 1) if g % p == 0
                and (max_cluster is None or g // p <= max_cluster)]
    fits = [p for p in divisors if 4 * SMS * p <= b * h * n]
    return max(fits) if fits else min(divisors)


@functools.lru_cache(maxsize=None)
def flash_bwd_plan(b: int, h: int, kh: int, sq: int, skv: int,
                   hd: int = 64, dv: Optional[int] = None
                   ) -> Tuple[LaunchPlan, LaunchPlan]:
    """(K2, K3) launch plans.  K2: one block per (q tile of 128 rows, run of
    p heads of one group, batch row), grid (B H / p, q tiles), the last q
    tile first (causally the longest).  K3: one block per (kv tile of 128
    keys, 64 past BWD_SPLIT, run of p query heads, batch row), the G / p
    blocks of a (kv tile, kv head, batch row) in one cluster; grid (G / p
    KH B, kv tiles), kv tile 0 (causally the longest) first.  p from
    ``bwd_heads_per_block``.  Shared memory at q/k width ``hd`` and v width
    ``dv`` (``hd`` if not given), each tile sized by its own width, padded
    to 32 columns (``padded``): the tiles (K2: its Q / dO slots), the
    mbarriers, the list of visible tiles."""
    dv = hd if dv is None else dv
    _check_widths("K2 / K3", hd, dv)
    g = h // kh
    hd, dv = padded(hd), padded(dv)
    split = hd + dv > BWD_SPLIT
    keys = BWD_SPLIT_KEYS if split else BWD_DKV_KEYS
    nq, nkv = -(-sq // BWD_DQ_ROWS), -(-skv // keys)
    slots = 1 if split else 2
    stages = 2 if hd + dv > BWD_DQ_WIDE and not split else BWD_STAGES
    p = bwd_heads_per_block(g, b, h, -(-skv // BWD_DQ_KEYS))
    dq = LaunchPlan(
        grid=(b * h // p, nq), cluster=1, tiles=tuple(range(nq - 1, -1, -1)),
        heads=(tuple(range(p)),),
        smem=1024 + slots * BWD_DQ_ROWS * (hd + dv) * 2
        + stages * BWD_DQ_KEYS * (hd + dv) * 2
        + (4 + 2 * stages) * 8 + 8 * 4 + -(-skv // BWD_DQ_KEYS) * 4)
    p = bwd_heads_per_block(g, b, h, -(-sq // BWD_DKV_ROWS), BWD_MAX_CLUSTER)
    c = g // p
    ring = (keys + BWD_STAGES * BWD_DKV_ROWS) * (hd + dv) * 2
    dkv = LaunchPlan(
        grid=(c * kh * b, nkv), cluster=c, tiles=tuple(range(nkv)),
        heads=tuple(tuple(range(r * p, (r + 1) * p)) for r in range(c)),
        smem=1024 + ring + BWD_STAGES * 3 * BWD_DKV_ROWS * 4
        + (1 + 2 * BWD_STAGES) * 8 + 8 * 4 + -(-sq // BWD_DKV_ROWS) * 4)
    return dq, dkv


def flash_backward_dq(q, k, v, go, m, l, di, qpos, kpos, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """K2.  Operands as ``flash_forward`` plus go (B, H, Sq, Dv) and the
    forward's m, l and di = rowsum(go * out) (B, H, Sq, 1) fp32.  Returns
    dq fp32 (B, H, Sq, D) w.r.t. the pre-scaled query, as a transposed
    view of a (B, Sq, H, D) buffer."""
    build.refuse_dtensor("flash_backward_dq", q, k, v, go, m, l, di, qpos, kpos)
    if not q.is_cuda:
        return attention_ref.flash_backward_ref(
            q, k, v, go, m, l, di, qpos, kpos, window=window)[0]
    b, h, sq, d = q.shape
    kh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    qpos, kpos = _check_flash("flash_backward_dq", q, k, v, qpos, kpos, go)
    m, l, di = _row_stats("flash_backward_dq", q, m, l, di)
    plan = flash_bwd_plan(b, h, kh, sq, skv, d, dv)[0]
    dq = torch.empty((b, sq, h, d), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    has_window, win = _window_args(window)
    build.launch(
        "flash_bwd_dq", "flash_bwd_dq_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), dq.data_ptr(), b, h, kh, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *go.stride()[:3], *dq.stride()[:3], has_window, win,
        plan.grid[1], len(plan.heads[0]), plan.smem, d, dv,
        build.current_stream())
    return dq


def flash_backward_dkv(q, k, v, go, m, l, di, qpos, kpos, *,
                       window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3.  Operands as ``flash_backward_dq``.  Returns (dk, dv) fp32
    (B, KH, Skv, D/Dv), each summed over the GQA group, as transposed
    views of (B, Skv, KH, D/Dv) buffers."""
    build.refuse_dtensor("flash_backward_dkv", q, k, v, go, m, l, di, qpos, kpos)
    if not q.is_cuda:
        _, dk, dv = attention_ref.flash_backward_ref(
            q, k, v, go, m, l, di, qpos, kpos, window=window)
        return dk, dv
    b, h, sq, d = q.shape
    kh, skv, d_v = k.shape[1], k.shape[2], v.shape[-1]
    qpos, kpos = _check_flash("flash_backward_dkv", q, k, v, qpos, kpos, go)
    m, l, di = _row_stats("flash_backward_dkv", q, m, l, di)
    plan = flash_bwd_plan(b, h, kh, sq, skv, d, d_v)[1]
    dk = torch.empty((b, skv, kh, d), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((b, skv, kh, d_v), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    has_window, win = _window_args(window)
    build.launch(
        "flash_bwd_dkv", "flash_bwd_dkv_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kh, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *go.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], has_window,
        win, plan.grid[1], plan.cluster, plan.smem, d, d_v,
        build.current_stream())
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


def head_placements(mesh, b: int, h: int, kh: int) -> Tuple:
    """DTensor placements of a (B, S, heads x D) operand of K1 – K3 on
    ``mesh``: the batch over every axis but ``model`` while B divides
    them, the heads (dim 2) over ``model`` when both H and KH divide it,
    else replicated there (a kernel cannot run on part of a head, and a
    GQA group must stay whole on a rank)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out, batch_ranks = [], 1
    for i, name in enumerate(names):
        size = mesh.size(i)
        if name == "model":
            whole = h % size == 0 and kh % size == 0
            out.append(Shard(2) if whole and size > 1 else Replicate())
        elif size > 1 and b % (batch_ranks * size) == 0:
            batch_ranks *= size
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return tuple(out)


def on_local_heads(fn, q, k, v, *rest, heads: Tuple[int, int]):
    """``fn(q, k, v, *rest)`` on each rank's local heads: K1 – K3 under a
    mesh.  q / k / v are the (B, S, heads x D) projections, ``heads`` =
    (H, KH); as DTensors they are redistributed to ``head_placements`` (an
    all-gather of the heads where they do not divide the ``model`` axis)
    and ``fn`` runs through ``local_map`` on the local shards, which it
    splits into heads itself: no DTensor view folds or unfolds a sharded
    head axis, which DTensor refuses on some torch versions.  ``rest``
    (positions) pass as they are, a DTensor among them replicated first.
    ``fn``'s (B, S, H x Dv) output comes back as a DTensor of the same
    placements, differentiable in q, k, v.  Plain tensors call ``fn``
    directly."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return fn(q, k, v, *rest)
    place = head_placements(q.device_mesh, q.shape[0], *heads)
    q, k, v = (t.redistribute(q.device_mesh, place) for t in (q, k, v))
    whole = [Replicate()] * q.device_mesh.ndim
    rest_place = tuple(whole if isinstance(t, DTensor) else None
                       for t in rest)
    heads = list(place)  # a list: one output's placements
    mapped = local_map(fn, out_placements=heads,
                       in_placements=(heads, heads, heads) + rest_place,
                       device_mesh=q.device_mesh, redistribute_inputs=True)
    return mapped(q, k, v, *rest)


def _check_decode(name: str, qf, k, v, scales, pos, qpos, code_dtype
                  ) -> torch.Tensor:
    """The checks every decode kernel makes of its operands: qf (R, KH, G,
    D) bf16, D in ``DECODE_HEAD_DIMS``; k / v (N, T, KH, D) of
    ``code_dtype``; ``scales`` the
    (N, T, KH) fp16 K and V scales of an int8 cache (empty otherwise); pos
    (N, T) int32; qpos (R,).  Returns qpos as contiguous int32."""
    r, kh, g, d = qf.shape
    lead = tuple(k.shape[:2])
    _check_bf16(name, qf)
    if k.dtype != code_dtype or v.dtype != code_dtype:
        raise TypeError(f"{name} takes {code_dtype} caches, got {k.dtype}")
    if any(t.dtype != torch.float16 for t in scales):
        raise TypeError(f"{name} takes fp16 scales")
    if pos.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 key positions")
    _check_device(name, qf, k, v, *scales, pos, qpos)
    if d not in DECODE_HEAD_DIMS:
        raise ValueError(f"{name} is compiled for head_dim "
                         f"{DECODE_HEAD_DIMS}, got {d} (a width no ROADMAP "
                         f"item queues)")
    if k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name} takes Dv = D, got q {d}, k {k.shape[-1]},"
                         f" v {v.shape[-1]}")
    if k.shape != lead + (kh, d) or v.shape != k.shape \
            or pos.shape != lead \
            or any(t.shape != lead + (kh,) for t in scales):
        raise ValueError(f"{name}: cache shapes disagree")
    if g > _MAX_G:
        raise ValueError(f"{name} takes G <= {_MAX_G}, got {g}")
    if qpos.shape != (r,):
        raise ValueError(f"{name}: qpos does not match the row axis")
    _check_contiguous(name, qf, k, v, *scales, pos)
    if qf.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name} takes a 16-byte aligned query and caches")
    return qpos.to(torch.int32).contiguous()


# K6 - K9 launch geometry (csrc/decode_paged.cu): 128 threads (4 warps) a
# block; a rank's pages go in rounds of at most this many K and V bytes
PAGED_ROUND_BYTES = 32768
PAGED_WARPS = 4
PAGED_MAX_CLUSTER = 8  # portable thread block cluster size
RING_PAGE = 16  # K6 / K7: keys in a virtual page of a ring row


class PagedPlan(NamedTuple):
    """K6 - K9's launch: ``grid`` blocks in clusters of ``cluster`` (one
    cluster per (row, kv head)); cluster rank r takes pages
    [r ppr, (r + 1) ppr) of the row (a slot's table row, or a ring row's
    virtual pages), ``ppr`` = ``pages_per_rank``; a rank's visible pages
    go in rounds of ``pages_per_round`` through ``buffers`` shared-memory
    buffers; ``smem`` the dynamic shared-memory bytes of a block."""
    grid: int
    cluster: int
    pages_per_rank: int
    pages_per_round: int
    buffers: int
    smem: int


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def decode_row(d: int, elem: int) -> int:
    """The elements a K or V row of head width ``d`` takes in a decode
    kernel's round buffer: ``d``, but a bf16 row of 80 is padded to 88, so
    that rows r and r + 4 do not share banks (csrc/decode_paged.cu,
    ``row_ld``)."""
    return d + 8 if elem == 2 and d % 64 else d


@functools.lru_cache(maxsize=None)
def decode_paged_plan(s: int, kh: int, npp: int, pg: int, g: int,
                      elem: int, d: int) -> PagedPlan:
    """K6 / K8 (``elem`` 2, bf16 caches) and K7 / K9 (``elem`` 1, int8
    codes with scales) launch plan for S rows, KH kv heads, npp pages of
    pg tokens a row (K8 / K9: table entries; K6 / K7: ``ceil(L /
    RING_PAGE)`` of ``RING_PAGE``), G query heads per kv head and head
    width ``d`` (a page's K and V rows take ``2 pg decode_row(d, elem)
    elem`` bytes, so a round holds half the pages at 128 that it holds at
    64).  The
    cluster is the fewest ranks, a power of two up to 8 and at most npp,
    that put a block on every SM; the ranks split the row's pages into
    equal ranges.  A round holds as many pages as fit PAGED_ROUND_BYTES of
    K and V (at least one); a rank whose pages may take more than one
    round gets two buffers.  Shared memory as ``Layout`` in the kernel:
    the round buffers (reused for the warps' partials), a visibility byte
    and (K7 / K9) two fp32 scales per buffered row, the rank's page
    entries, its list of visible pages, a flag per page and per key, the
    block's partial, a count."""
    want = -(-SMS // (s * kh))
    c = 1
    while c < want and 2 * c <= min(PAGED_MAX_CLUSTER, npp):
        c *= 2
    ppr = -(-npp // c)
    row = decode_row(d, elem) * elem  # bytes of a buffered K or V row
    rnd = min(ppr, max(1, PAGED_ROUND_BYTES // (2 * pg * row)))
    nbuf = 1 if rnd >= ppr else 2
    kr = _r16(rnd * pg)
    part = (2 * _MAX_G + g * d) * 4
    smem = (_r16(max(nbuf * 2 * kr * row, PAGED_WARPS * part))
            + _r16(nbuf * kr) + (nbuf * kr * 8 if elem == 1 else 0)
            + 2 * _r16(ppr * 4) + _r16(ppr) + _r16(ppr * pg) + part + 16)
    return PagedPlan(grid=s * kh * c, cluster=c, pages_per_rank=ppr,
                     pages_per_round=rnd, buffers=nbuf, smem=smem)


def _decode_plan(kernel: str, qf: torch.Tensor, npp: int, pg: int,
                 elem: int) -> PagedPlan:
    """The plan of a decode kernel's launch; raises if it needs more shared
    memory than a block has.  Beside the round buffers a rank keeps 9 + pg
    bytes a page (its entries, visible list and flags), so a row of more
    than ``row_key_limit`` keys (some 800 000 at G 4 with clusters of 8,
    at either width) does not fit."""
    r, kh, g, d = qf.shape
    plan = decode_paged_plan(r, kh, npp, pg, g, elem, d)
    if plan.smem > SMEM_MAX:
        limit = row_key_limit(r, kh, pg, g, elem, d)
        raise ValueError(
            f"{kernel}: {npp} pages of {pg} need {plan.smem} B of shared "
            f"memory a block, over {SMEM_MAX}; at {r} rows of {kh} kv heads,"
            f" G {g} and head width {d} a row takes at most {limit} keys")
    return plan


@functools.lru_cache(maxsize=None)
def row_key_limit(s: int, kh: int, pg: int, g: int, elem: int,
                  d: int) -> int:
    """The most keys (whole pages of ``pg``) a row may hold before its
    launch plan exceeds ``SMEM_MAX``: the plan grows with the page count,
    so the limit is found by bisection over it."""
    def fits(npp):
        return decode_paged_plan(s, kh, npp, pg, g, elem, d).smem <= SMEM_MAX

    lo, hi = 1, 2
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo * pg


def _ring_decode(kernel: str, fn_name: str, qf, k, v, scales, kpos, qpos,
                 window, code_dtype) -> torch.Tensor:
    qpos = _check_decode(kernel, qf, k, v, scales, kpos, qpos, code_dtype)
    b, kh, g, _ = qf.shape
    if k.shape[0] != b:
        raise ValueError(f"{kernel}: the cache does not match the batch")
    length = k.shape[1]
    plan = _decode_plan(kernel, qf, -(-length // RING_PAGE), RING_PAGE,
                        k.element_size())
    out = torch.empty(qf.shape, dtype=torch.float32, device=qf.device)
    has_window, win = _window_args(window)
    build.launch(kernel, fn_name, qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *[t.data_ptr() for t in scales], kpos.data_ptr(),
                 qpos.data_ptr(), out.data_ptr(), b, length, kh, g,
                 RING_PAGE, has_window, win, *plan[1:], qf.shape[-1],
                 build.current_stream())
    return out


def decode(qf: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           kpos: torch.Tensor, qpos: torch.Tensor, *,
           window: Optional[int] = None) -> torch.Tensor:
    """K6.  qf: (B, KH, G, D) pre-scaled; caches (B, L, KH, D/Dv) in the
    ring layout, any L; kpos (B, L) int32 (-1 empty); qpos (B,).  Returns
    (B, KH, G, Dv) fp32; a row with no visible key gives 0."""
    build.refuse_dtensor("decode", qf, k_cache, v_cache, kpos,
                         qpos)
    if not qf.is_cuda:
        return attention_ref.decode_attention_ref(
            qf, k_cache, v_cache, kpos, qpos, window=window)
    return _ring_decode("decode", "decode_bf16", qf, k_cache, v_cache, (),
                        kpos, qpos, window, torch.bfloat16)


def decode_q8(qf: torch.Tensor, k_codes: torch.Tensor,
              v_codes: torch.Tensor, k_scale: torch.Tensor,
              v_scale: torch.Tensor, kpos: torch.Tensor, qpos: torch.Tensor,
              *, window: Optional[int] = None) -> torch.Tensor:
    """K7.  As ``decode`` over int8 codes (B, L, KH, D) with fp16 scales
    (B, L, KH), which the kernel reads where they lie (the reference's
    wrapper makes an fp32 (B, KH, L) copy first).  Returns (B, KH, G, D)
    fp32."""
    build.refuse_dtensor("decode_q8", qf, k_codes, v_codes, k_scale,
                         v_scale, kpos, qpos)
    if not qf.is_cuda:
        return attention_ref.decode_attention_q8_ref(
            qf, k_codes, v_codes, k_scale, v_scale, kpos, qpos,
            window=window)
    return _ring_decode("decode_q8", "decode_q8", qf, k_codes, v_codes,
                        (k_scale, v_scale), kpos, qpos, window, torch.int8)


def _paged_decode(kernel: str, fn_name: str, qf, k_pool, v_pool, scales,
                  pos_pool, page_table, qpos, window, code_dtype
                  ) -> torch.Tensor:
    qpos = _check_decode(kernel, qf, k_pool, v_pool, scales, pos_pool, qpos,
                         code_dtype)
    s, kh, g, _ = qf.shape
    pg = k_pool.shape[1]
    if pg > _MAX_PAGE:
        raise ValueError(f"{kernel} takes pages of <= {_MAX_PAGE} tokens, "
                         f"got {pg}")
    if page_table.ndim != 2 or page_table.shape[0] != s:
        raise ValueError(f"{kernel}: page_table does not match the slots")
    _check_device(kernel, qf, page_table)
    page_table = page_table.to(torch.int32).contiguous()
    npp = page_table.shape[1]
    plan = _decode_plan(kernel, qf, npp, pg, k_pool.element_size())
    out = torch.empty(qf.shape, dtype=torch.float32, device=qf.device)
    has_window, win = _window_args(window)
    build.launch(kernel, fn_name, qf.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), *[t.data_ptr() for t in scales],
                 pos_pool.data_ptr(), page_table.data_ptr(), qpos.data_ptr(),
                 out.data_ptr(), s, kh, g, pg, npp, has_window, win,
                 *plan[1:], qf.shape[-1], build.current_stream())
    return out


def decode_paged(qf: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, pos_pool: torch.Tensor,
                 page_table: torch.Tensor, qpos: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """K8.  qf: (S, KH, G, D) pre-scaled; pools (P, pg, KH, D/Dv); pos_pool
    (P, pg) int32 (-1 empty); page_table (S, npp) (-1 unallocated); qpos
    (S,) (-1 inactive: the slot's output is 0).  Returns (S, KH, G, Dv)
    fp32.  The kernel reads each slot's pages where they lie in the pool:
    no gathered copy of the cache is made."""
    build.refuse_dtensor("decode_paged", qf, k_pool, v_pool, pos_pool,
                         page_table, qpos)
    if not qf.is_cuda:
        return attention_ref.decode_attention_paged_ref(
            qf, k_pool, v_pool, pos_pool, page_table, qpos, window=window)
    return _paged_decode("decode_paged", "decode_paged_bf16", qf, k_pool,
                         v_pool, (), pos_pool, page_table, qpos, window,
                         torch.bfloat16)


def decode_paged_q8(qf: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale_pool: torch.Tensor,
                    v_scale_pool: torch.Tensor, pos_pool: torch.Tensor,
                    page_table: torch.Tensor, qpos: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """K9.  As ``decode_paged`` over int8 code pools (P, pg, KH, D) with
    fp16 scale pools (P, pg, KH), read where they lie.  Returns
    (S, KH, G, D) fp32."""
    build.refuse_dtensor("decode_paged_q8", qf, k_pool, v_pool,
                         k_scale_pool, v_scale_pool, pos_pool,
                         page_table, qpos)
    if not qf.is_cuda:
        return attention_ref.decode_attention_paged_q8_ref(
            qf, k_pool, v_pool, k_scale_pool, v_scale_pool, pos_pool,
            page_table, qpos, window=window)
    return _paged_decode("decode_paged_q8", "decode_paged_q8", qf, k_pool,
                         v_pool, (k_scale_pool, v_scale_pool), pos_pool,
                         page_table, qpos, window, torch.int8)
