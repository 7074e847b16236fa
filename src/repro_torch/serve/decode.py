"""Serving prefill (port of ``repro/serve/decode.py``: ``cache_length`` and
``prefill``).  The static ``generate`` loop over a ring cache, with its
K6 decode kernel, is a later slice (ROADMAP queue K)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def cache_length(cfg: ArchConfig, seq_len: int,
                 window: Optional[int]) -> int:
    """Ring-buffer size: full history, or the window for long context."""
    if window is not None:
        return min(seq_len, window)
    return seq_len


@torch.inference_mode()
def prefill(params: Dict, cfg: ArchConfig, batch: Dict, cache_len: int, *,
            window: Optional[int] = None):
    """Run the full-sequence pass and return (logits, caches)."""
    logits, _aux, caches = tf.forward(params, cfg, batch, window=window,
                                      collect_cache=cache_len)
    return logits, caches
