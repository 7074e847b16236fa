"""End-to-end driver: the paper's full training recipe on a small
Quantized-TinyLLaVA (port of ``examples/split_training_e2e.py``:
``build_cfg``, ``run_e2e``, ``run_hub_async`` and ``run_lora``).

Composite CE + alpha * L_comm loss, the 2-bit RD-FSQ compressor at the
connector cut, warmup-cosine AdamW, a checkpoint at the end:

    PYTHONPATH=src python -m repro_torch.launch.e2e --device cpu \
        --steps 40 --batch 8 --seq 48

``--mode hub-async`` drives the many-client hub's async mode
(``launch/split_hub.train_hub``): N clients with 2-bit RD-FSQ / 4-bit NF
links alternating and tick rates ``1 + c % 3`` train their bottom halves
against one shared server half, the server stepping per arrival, the
cotangent through ``--method`` / ``--bits``:

    PYTHONPATH=src python -m repro_torch.launch.e2e --device cpu \
        --mode hub-async --clients 3 --steps 30

``--mode lora`` trains SplitLoRA on the async hub: rank ``--lora-rank``
adapters on a frozen base, 2-bit RD-FSQ / 4-bit NF links alternating,
tick rates ``1 + c % 2``, each client's adapter gradient through the 8-bit
RD-FSQ codec (``stats_axis="tensor"``); it saves the adapters alone:

    PYTHONPATH=src python -m repro_torch.launch.e2e --device cpu \
        --mode lora --lora-rank 4 --steps 30

Runs on CUDA unless ``--device cpu`` is given.  SplitLoRA on the chain
pipeline is ``launch/split_pipeline.py --lora-rank``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import HubConfig, SplitConfig
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


def run_hub_async(cfg, args):
    """The many-client hub on the split stack: clients alternate 2-bit
    RD-FSQ / 4-bit NF links and tick at different rates; the shared server
    steps per arrival and each client's wire calibration stays its own.
    The hub schedules the LLM stack (embed, blocks, head), so the VLM
    config runs in text modality and the cut is the block stack's
    midpoint, not the connector."""
    from repro_torch.launch.split_hub import train_hub

    cfg = dataclasses.replace(cfg, modality="text")
    n = args.clients
    hub = HubConfig(
        n_clients=n,
        client_quants=tuple(
            QuantConfig(method="rdfsq", bits=2) if c % 2 == 0
            else QuantConfig(method="nf", bits=4) for c in range(n)),
        bwd_quant=QuantConfig(method=args.method, bits=args.bits),
        tick_rates=tuple(1 + c % 3 for c in range(n)))
    pipe = make_pipeline(cfg, n * args.batch, args.seq, seed=0)

    def batches():
        while True:
            b = next(pipe)
            yield (b["tokens"].reshape(n, args.batch, -1),
                   b["labels"].reshape(n, args.batch, -1))

    out = train_hub(cfg, hub, AdamWConfig(lr=args.lr), batches(),
                    micro_batch=args.batch, seq=args.seq, mode="async",
                    n_ticks=args.steps, device=args.device)
    hist = out["history"]
    for i in range(0, len(hist), max(len(hist) // 10, 1)):
        arrived = int(out["masks"][i].sum())
        print(f"  tick {i:4d} loss={hist[i]:.4f} arrivals={arrived}/{n}")
    print(f"hub loss {hist[0]:.4f} -> {hist[-1]:.4f} over {args.steps} "
          f"ticks; per-client wire rel err "
          + ", ".join(f"{v:.4f}" for v in out["quant_rel_err"]))


def run_lora(cfg, args):
    """SplitLoRA on the async hub: the base stays bit-frozen, the adapters
    alone train (moments sized by them), each client's adapter gradient
    crosses the 8-bit codec; the adapters are saved alone."""
    from repro_torch.launch.split_hub import GRAD_QUANT, train_hub
    from repro_torch.optim import param_bytes
    from repro_torch.peft import adapter_bytes

    cfg = dataclasses.replace(cfg, modality="text")
    n, r = args.clients, args.lora_rank
    hub = HubConfig(
        n_clients=n,
        client_quants=tuple(
            QuantConfig(method="rdfsq", bits=2) if c % 2 == 0
            else QuantConfig(method="nf", bits=4) for c in range(n)),
        grad_quant=GRAD_QUANT,
        tick_rates=tuple(1 + c % 2 for c in range(n)))
    pipe = make_pipeline(cfg, n * args.batch, args.seq, seed=0)

    def batches():
        while True:
            b = next(pipe)
            yield (b["tokens"].reshape(n, args.batch, -1),
                   b["labels"].reshape(n, args.batch, -1))

    out = train_hub(cfg, hub, AdamWConfig(lr=args.lr), batches(),
                    micro_batch=args.batch, seq=args.seq, mode="async",
                    n_ticks=args.steps, lora_rank=r, device=args.device)
    hist = out["history"]
    for i in range(0, len(hist), max(len(hist) // 10, 1)):
        print(f"  tick {i:4d} loss={hist[i]:.4f}")
    state = out["state"]
    adapters = dict(server=state["server"].params["adapters"],
                    clients=state["client_adapters"])
    full_b = param_bytes(state["client_params"]) \
        + param_bytes(state["server"].params["blocks"])
    ad_b = adapter_bytes(adapters)
    print(f"lora(r={r}) loss {hist[0]:.4f} -> {hist[-1]:.4f} over "
          f"{args.steps} ticks; adapters {ad_b / 1024:.0f} KiB vs frozen "
          f"base {full_b / 1024:.0f} KiB ({full_b / max(ad_b, 1):.0f}x)")
    checkpoint.save_adapters(args.ckpt, adapters)
    print("adapter checkpoint:", args.ckpt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("e2e", "hub-async", "lora"),
                    default="e2e")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--method", default="rdfsq")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--lora-rank", type=int, default=4)
    ap.add_argument("--ckpt", default="qtllava_e2e.npz")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.d_model, args.layers, args.method, args.bits)
    n = tree_count(init_params(cfg, device="cpu"))  # a throwaway CPU copy
    print(f"training {cfg.name}: ~{n / 1e6:.1f}M params, {args.method}-"
          f"{args.bits}bit split compressor, {args.steps} steps, "
          f"mode={args.mode}")
    if args.mode == "hub-async":
        run_hub_async(cfg, args)
    elif args.mode == "lora":
        run_lora(cfg, args)
    else:
        run_e2e(cfg, args)


if __name__ == "__main__":
    main()
