"""Quickstart (the twin of ``examples/quickstart.py``): train
Quantized-TinyLLaVA with the 2-bit RD-FSQ split compressor on the
synthetic VQA task, measure the answer accuracy on fresh data, and
generate through the quantized cut.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps 100]
        [--full] [--device cpu]

``--full`` trains tinyllava at its full width (16 layers, d 1 280, 729
image tokens) in place of ``reduced()``.  The ring caches of ``generate``
hold the image tokens, the 8 prompt tokens and the 8 new ones
(``serve.decode.cache_length``); the reference's 64 fits only
``reduced()``'s 16 image tokens.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.serve.decode import cache_length, generate
from repro_torch.train.loop import batch_to, train_loop
from repro_torch.train.losses import IGNORE
from repro_torch.utils.tree import tree_leaves

PROMPT, N_NEW = 8, 8


def run(steps: int = 100, full: bool = False, device=None) -> Dict:
    """Train, evaluate and generate; returns the trained state, the
    history, the accuracy, the generated ids and the ring length."""
    cfg = get_config("tinyllava")
    cfg = cfg if full else cfg.reduced()
    q = cfg.split.quant
    print(f"model: {cfg.name} ({'full width' if full else 'reduced'}) | "
          f"split cut after connector | compressor: {q.method}-{q.bits}bit")

    data = make_pipeline(cfg, batch_size=8, seq_len=32, seed=0)
    state, history = train_loop(
        cfg, AdamWConfig(lr=2e-3), data, n_steps=steps,
        log_every=max(steps // 5, 1), device=device,
        callback=lambda i, m: print(
            f"  step {i:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
            f"commit={m['commit']:.4f}"))

    # answer accuracy on fresh data
    dev = tree_leaves(state.params)[0].device
    batch = batch_to(next(make_pipeline(cfg, 16, 32, seed=99)), dev)
    with torch.no_grad():
        logits, _ = tf.forward(state.params, cfg, batch)
    labels = batch["labels"]
    mask = labels != IGNORE
    acc = float((mask & (logits.argmax(dim=-1) == labels)).sum()
                / mask.sum())
    print(f"answer-token accuracy: {acc:.3f}")

    # autoregressive generation through the quantized cut
    gen_batch = dict(image_embeds=batch["image_embeds"][:2],
                     tokens=batch["tokens"][:2, :PROMPT])
    cache_len = cache_length(cfg, cfg.n_image_tokens + PROMPT + N_NEW, None)
    out = generate(state.params, cfg, gen_batch, n_new=N_NEW,
                   cache_len=cache_len)
    print("generated token ids:", out.tolist())
    return dict(state=state, history=history, acc=acc,
                generated=out.tolist(), cache_len=cache_len)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="full-width tinyllava in place of reduced()")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path (default: CUDA)")
    args = ap.parse_args(argv)
    run(args.steps, args.full, args.device)


if __name__ == "__main__":
    main()
