"""End-to-end driver: the paper's full training recipe on a small
Quantized-TinyLLaVA (port of ``examples/split_training_e2e.py --mode
e2e``: ``build_cfg`` and ``run_e2e``).

Composite CE + alpha * L_comm loss, the 2-bit RD-FSQ compressor at the
connector cut, warmup-cosine AdamW, a checkpoint at the end:

    PYTHONPATH=src python -m repro_torch.launch.e2e --device cpu \
        --steps 40 --batch 8 --seq 48

Runs on CUDA unless ``--device cpu`` is given.  The hub and SplitLoRA
modes of the example are ROADMAP item M9.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import SplitConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models.transformer import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import train_loop
from repro_torch.utils.tree import tree_count


def build_cfg(d_model: int, layers: int, method: str, bits: int):
    base = get_config("tinyllava")
    heads = max(d_model // 64, 4)
    return dataclasses.replace(
        base,
        n_layers=layers, d_model=d_model, n_heads=heads,
        n_kv_heads=max(heads // 4, 1), head_dim=64,
        d_ff=int(d_model * 8 / 3) // 64 * 64,
        vocab_size=8192, n_image_tokens=36, d_vision=256,
        d_connector=d_model,
        param_dtype="float32", compute_dtype="float32", remat=False,
        split=SplitConfig(cut_layer=0,
                          quant=QuantConfig(method=method, bits=bits),
                          learnable_codec=True),
    )


def run_e2e(cfg, args):
    """The paper's recipe: forward with the in-graph compressor roundtrip
    at the cut, composite loss, checkpointing."""
    data = make_pipeline(cfg, args.batch, args.seq, seed=0)
    state, history = train_loop(
        cfg, AdamWConfig(lr=args.lr), data, n_steps=args.steps,
        log_every=max(args.steps // 10, 1), device=args.device,
        callback=lambda i, m: print(
            f"  step {i:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
            f"commit={m['commit']:.4f} lr={m['lr']:.2e}"))
    first, last = history[0][1]["ce"], history[-1][1]["ce"]
    print(f"CE {first:.4f} -> {last:.4f} "
          f"({(1 - last / first) * 100:.1f}% reduction)")
    checkpoint.save(args.ckpt, state)
    print("checkpoint:", args.ckpt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--method", default="rdfsq")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="qtllava_e2e.npz")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.d_model, args.layers, args.method, args.bits)
    n = tree_count(init_params(cfg, device="cpu"))  # a throwaway CPU copy
    print(f"training {cfg.name}: ~{n / 1e6:.1f}M params, {args.method}-"
          f"{args.bits}bit split compressor, {args.steps} steps, mode=e2e")
    run_e2e(cfg, args)


if __name__ == "__main__":
    main()
