"""Batched serving demo (port of ``examples/serve_batched.py``): prefill +
the static decode loop over ring KV caches, with the split compressor on
the decode path, or the continuous-batching engine; a vlm config
(``tinyllava``, requests with image embeddings) or a text one
(``llama3_2_3b``, token prompts alone).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched
    PYTHONPATH=src python -m repro_torch.launch.serve_batched --engine \
        --split-serve
    PYTHONPATH=src python -m repro_torch.launch.serve_batched \
        --arch llama3_2_3b --full --engine

Runs on CUDA unless ``--device cpu`` is given, at the reduced config
unless ``--full`` is given.  Without ``--engine`` it runs ``prefill`` and
the ``make_serve_step`` loop (kernels K1 then K6, or K7 for an int8 KV
cache); with ``--engine`` it runs ``ServeEngine`` (K1 and K8 / K9, plus
K4 / K5 with ``--split-serve``).  The static ring holds the image tokens
too: its length is image + prompt + new tokens (or the window), where the
reference's example leaves the image out and so drops the oldest image
positions.  ``--engine --weight-quant int4`` (or ``int3``) serves from
GPTQ-quantized packed weights, calibrated on a 4-row batch of the data
pipeline; every w* matmul of the block stacks then runs K12.  A hybrid
config (``--arch zamba2_2_7b``) serves through prefill and the static
loop, its mamba2 layers on their {state, conv} caches; ``--engine`` raises
``NotImplementedError`` for it, as the reference does: the paged pools
have no mamba2 form.  So does rwkv6_7b (``--arch rwkv6-7b``, its
{tmix: {state, x_last}, cmix_last} caches; no paged form either).  An
audio config (``--arch musicgen_large``) serves a prompt of (B, K, S)
codes: each step picks one code a codebook and feeds back (B, K, 1);
``--engine`` raises for it, in the reference's words.  (The reference's
example fails on its first audio step, broadcasting the (B, 1, K) first
pick to (B, K, 1); the port does not copy that fault.)
"""
from __future__ import annotations

import argparse
import statistics
import time


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _n_image_tokens(cfg) -> int:
    return cfg.n_image_tokens if cfg.modality == "vlm" else 0


def run_engine(cfg, params, args, device) -> None:
    import torch

    from repro_torch.serve.engine import ServeEngine

    gen = torch.Generator().manual_seed(0)
    page_size = 8
    max_target = _n_image_tokens(cfg) + args.prompt_len + args.new_tokens
    wq_calib = None
    if args.weight_quant:
        # a small GPTQ calibration sample; without one the engine takes
        # round-to-nearest
        from repro_torch.data.pipeline import make_pipeline
        wq_calib = next(make_pipeline(cfg, 4, 32))
    eng = ServeEngine(
        params, cfg, n_slots=max(2, args.batch // 2), page_size=page_size,
        n_pages=1 + args.batch * -(-max_target // page_size),
        window=args.window,
        split_wire=cfg.split.quant if args.split_serve else None,
        weight_quant=args.weight_quant, wq_calib=wq_calib, device=device)
    for i in range(args.batch):
        toks = torch.randint(0, cfg.vocab_size, (args.prompt_len,),
                             generator=gen)
        img = None
        if cfg.modality == "vlm":
            img = torch.randn((cfg.n_image_tokens, cfg.d_vision),
                              generator=gen).to(device)
        # staggered budgets: early retirements open slots for admissions
        eng.submit(toks.tolist(),
                   max_new=max(1, args.new_tokens - (i % 3) * 2),
                   image_embeds=img)
    t0 = time.perf_counter()
    results = eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    print(f"[{cfg.name}] engine: {len(results)} requests over "
          f"{eng.scheduler.n_slots} slots -> {total} tokens in "
          f"{dt * 1e3:.0f} ms ({total / dt:.1f} tok/s); "
          f"prefill_batches={eng.stats['prefill_batches']} "
          f"decode_ticks={eng.stats['decode_ticks']} "
          f"page_buckets={sorted(eng.stats['page_table_buckets'])}")
    if args.split_serve:
        print(f"  split-serve wire: {eng.stats['wire_bytes']} bytes of "
              f"quantized connector activations shipped")
    if args.weight_quant:
        d, p = eng.stats["weight_bytes_dense"], \
            eng.stats["weight_bytes_packed"]
        print(f"  {args.weight_quant} weights: {p} B packed vs {d} B "
              f"dense ({d / p:.2f}x smaller, GPTQ-calibrated)")


def run_static(cfg, params, args, device) -> None:
    import torch

    from repro_torch.serve.decode import cache_length, make_serve_step, \
        prefill

    gen = torch.Generator().manual_seed(0)
    n_img = _n_image_tokens(cfg)
    cache_len = cache_length(cfg, n_img + args.prompt_len + args.new_tokens,
                             args.window)
    batch = {}
    audio = cfg.modality == "audio"
    if cfg.modality == "vlm":
        batch["image_embeds"] = torch.randn(
            (args.batch, n_img, cfg.d_vision), generator=gen).to(device)
    prompt = (args.batch,) + ((cfg.n_codebooks,) if audio else ()) \
        + (args.prompt_len,)
    batch["codes" if audio else "tokens"] = torch.randint(
        0, cfg.vocab_size, prompt, generator=gen).to(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, batch, cache_len,
                             window=args.window)
    _sync(device)
    print(f"[{cfg.name}] prefill({args.batch}x{args.prompt_len}) "
          f"in {(time.perf_counter() - t0) * 1e3:.1f} ms; "
          f"cache_len={cache_len}")

    serve_step = make_serve_step(cfg, window=args.window)
    tok = logits[:, -1].argmax(dim=-1)
    pos0 = n_img + args.prompt_len
    times = []
    for i in range(args.new_tokens):
        qpos = torch.full((args.batch,), pos0 + i, dtype=torch.int32,
                          device=device)
        t0 = time.perf_counter()
        step_batch = dict(codes=tok[..., None]) if audio \
            else dict(tokens=tok[:, None])
        logits, caches = serve_step(params, caches, step_batch, qpos)
        _sync(device)
        times.append(time.perf_counter() - t0)
        tok = logits[:, -1].argmax(dim=-1)
    steady = statistics.median(times[1:] or times)
    print(f"decoded {args.new_tokens} tokens; median step "
          f"{steady * 1e3:.2f} ms ({args.batch / steady:.1f} tok/s "
          f"aggregate)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllava")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching ServeEngine instead of the "
                         "manual static loop")
    ap.add_argument("--split-serve", action="store_true",
                    help="(with --engine) ship connector activations over "
                         "the quantized wire")
    ap.add_argument("--weight-quant", default=None,
                    choices=("int4", "int3"),
                    help="(with --engine) serve from GPTQ-quantized packed "
                         "weights (repro_torch.wq, kernel K12)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    if args.split_serve and not args.engine:
        ap.error("--split-serve needs --engine")
    if args.weight_quant and not args.engine:
        ap.error("--weight-quant needs --engine")

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = tf.init_params(cfg, seed=0, device=device)
    if args.engine:
        run_engine(cfg, params, args, device)
    else:
        run_static(cfg, params, args, device)


if __name__ == "__main__":
    main()
