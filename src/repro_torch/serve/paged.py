"""Device-side pieces of the paged serving engine (port of
``repro/serve/paged.py``).

* ``paged_step``: one decode tick over the slot batch
  (``transformer.decode_step_paged``).
* ``insert_prefill``: scatter a freshly prefilled contiguous ring cache
  (``serve/decode.prefill`` with ``cache_len = npb * page_size``) into the
  paged pools at each request's physical pages.  Positions at or beyond a
  row's valid length become -1, and logical pages past a row's allocation
  go to the trash page 0.

Both write the pools IN PLACE, where the reference donates them to a jit
and gets new ones back: no copy of the pool is ever made.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (bucket quantizer for batch shapes)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def init_pools(cfg: ArchConfig, n_pages: int, page_size: int,
               device: DeviceLike = None) -> Dict:
    """Paged KV pools in the serve compute dtype (the dtype the prefill
    caches are collected in, so ``insert_prefill`` is a pure move), on
    ``device`` (CUDA unless ``device="cpu"``)."""
    return tf.init_paged_caches(cfg, n_pages, page_size,
                                dtype=tf.cdtype(cfg),
                                device=resolve_device(device))


@torch.inference_mode()
def paged_step(params: Dict, cfg: ArchConfig, pools: Dict, batch: Dict,
               qpos: torch.Tensor, page_table: torch.Tensor, *,
               window: Optional[int] = None):
    """One decode tick; returns (logits, pools), the pools updated."""
    return tf.decode_step_paged(params, cfg, pools, batch, qpos, page_table,
                                window=window)


@torch.inference_mode()
def insert_prefill(pools: Dict, caches: Dict, page_rows: torch.Tensor,
                   valid_len: torch.Tensor) -> Dict:
    """Scatter prefill caches (n, B, Lb, ...) into pools (n, P, pg, ...)
    at ``page_rows`` (B, npb); returns ``pools``, written in place.

    Several rows may send pages to the trash page 0; those writes all
    carry pos = -1, so which one lands is unobservable."""
    b, npb = page_rows.shape
    rows = page_rows.long()
    for side, segs in pools.items():
        for seg, pool_seg in segs.items():
            cache_seg = caches[side][seg]
            lb = cache_seg["pos"].shape[2]
            pg = pool_seg["pos"].shape[2]
            if lb != npb * pg:
                raise ValueError(f"cache length {lb} != {npb} pages of {pg}")
            valid = (torch.arange(lb, device=valid_len.device)[None, :]
                     < valid_len[:, None])
            for key, pool_leaf in pool_seg.items():
                val = cache_seg[key]  # (n, B, Lb, ...)
                if key == "pos":
                    val = torch.where(valid[None], val, -1)
                n = val.shape[0]
                pool_leaf[:, rows] = val.reshape(
                    (n, b, npb, pg) + tuple(val.shape[3:])).to(
                        pool_leaf.dtype)
    return pools
