"""Serving: prefill, the one-token decode step and batched autoregressive
generation over ring KV caches (port of ``repro/serve/decode.py``:
``cache_length``, ``make_serve_step``, ``prefill`` and ``generate``).

Both the prefill (``transformer.forward`` with cache collection) and the
per-token step (``transformer.decode_step``) run the layer stack through
``models/stack.py``.  On CUDA tensors each step's attention is K6 (16-bit
caches) or K7 (int8 caches, ``kv_cache_bits=8``).

The reference's ``compiled_serve_step`` / ``_compiled_prefill`` are
``jax.jit`` caches keyed by the ``REPRO_ATTN_IMPL`` backend and donate the
caches.  PyTorch runs eagerly and the port has neither a second attention
backend nor anything to compile, so they have no counterpart: the step
updates the caches in place instead of donating them.  A CUDA graph of
the step is the later analogue.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def cache_length(cfg: ArchConfig, seq_len: int,
                 window: Optional[int]) -> int:
    """Ring-buffer size: full history, or the window for long context."""
    if window is not None:
        return min(seq_len, window)
    return seq_len


def make_serve_step(cfg: ArchConfig, *,
                    window: Optional[int] = None) -> Callable:
    """``serve_step(params, caches, batch, qpos) -> (logits, caches)``:
    one new token against the ring caches, updated in place."""

    @torch.inference_mode()
    def serve_step(params, caches, batch: Dict, qpos: torch.Tensor):
        return tf.decode_step(params, cfg, caches, batch, qpos,
                              window=window)

    return serve_step


@torch.inference_mode()
def prefill(params: Dict, cfg: ArchConfig, batch: Dict, cache_len: int, *,
            window: Optional[int] = None):
    """Run the full-sequence pass and return (logits, caches)."""
    logits, _aux, caches = tf.forward(params, cfg, batch, window=window,
                                      collect_cache=cache_len)
    return logits, caches


@torch.inference_mode()
def generate(params: Dict, cfg: ArchConfig, batch: Dict, *, n_new: int,
             cache_len: int, window: Optional[int] = None,
             temperature: float = 0.0, seed: int = 0,
             eos_id: Optional[int] = None, pad_id: int = 0) -> torch.Tensor:
    """Prefill + greedy or sampled generation of ``n_new`` tokens.

    Returns (B, n_new) token ids on the batch's device; for an audio
    config (a prompt of ``codes`` (B, K, S)) (B, n_new, K): each step picks
    one code a codebook and feeds them back as ``codes`` (B, K, 1), and a
    row is done when every codebook emits ``eos_id``.  ``temperature >
    0`` samples by the Gumbel-max trick from a ``torch.Generator`` seeded
    with ``seed`` on that device; its draws are not the reference's
    ``jax.random`` ones, so only greedy decoding matches it token for
    token.  ``eos_id`` freezes a row that emits EOS (every later position
    is ``pad_id``) and ends the loop as soon as every row is done.  As in
    the reference, the step runs ``n_new`` times and the last step's logits
    go unused.
    """
    logits, caches = prefill(params, cfg, batch, cache_len, window=window)
    audio = cfg.modality == "audio"
    if audio:
        bsz, prompt_len = batch["codes"].shape[0], batch["codes"].shape[-1]
    else:
        bsz = batch["tokens"].shape[0]
        prompt_len = batch["tokens"].shape[1] \
            + (cfg.n_image_tokens if cfg.modality == "vlm" else 0)
    dev = logits.device
    step = make_serve_step(cfg, window=window)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        """(B,) from (B, S, V), or (B, K) from audio's (B, S, K, V)."""
        last = logits[:, -1].float()
        if temperature <= 0.0:
            return last.argmax(dim=-1)
        u = torch.rand(last.shape, generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return (last / temperature + gumbel).argmax(dim=-1)

    out = []
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    tok = pick(logits)
    for i in range(n_new):
        if eos_id is not None:
            d = done[:, None] if audio else done
            tok = torch.where(d, pad_id, tok)
            hit = tok == eos_id
            done = done | (hit.all(dim=-1) if audio else hit)
        out.append(tok)
        if eos_id is not None and i + 1 < n_new and bool(done.all()):
            out.extend([torch.full_like(tok, pad_id)] * (n_new - i - 1))
            break
        qpos = torch.full((bsz,), prompt_len + i, dtype=torch.int32,
                          device=dev)
        step_batch = dict(codes=tok[..., None]) if audio \
            else dict(tokens=tok[:, None])
        logits, caches = step(params, caches, step_batch, qpos)
        tok = pick(logits)
    return torch.stack(out, dim=1)
