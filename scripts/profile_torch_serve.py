#!/usr/bin/env python3
"""Where a decode tick of the port's split-serve engine, a static decode
step, or a training step spends its time.

    python3 scripts/profile_torch_serve.py               # decode ticks
    python3 scripts/profile_torch_serve.py --weight-quant int4  # int4 ticks
    python3 scripts/profile_torch_serve.py --kv-bits 8  # int8 KV pool ticks
    python3 scripts/profile_torch_serve.py --generate    # static steps
    python3 scripts/profile_torch_serve.py --train       # training steps
    python3 scripts/profile_torch_serve.py --prefill     # prefill batches
    python3 scripts/profile_torch_serve.py --prefill --wire nf  # NF-4 wire
    python3 scripts/profile_torch_serve.py --prefill --src DIR  # another tree

Needs one CUDA device.  By default it builds the same full-width
tinyllava engine and requests as ``chip_smoke.py``'s serve phase, steps it
until every request has been admitted (so no prefill runs afterwards),
then traces ``TICKS`` pure decode ticks; ``--weight-quant int4`` builds
the engine with RTN int4 weights (K12 at every w* site of the blocks),
``--kv-bits 8`` with int8 KV pools (K9 in place of K8).
With ``--generate`` it prefills
the generate phase's 4 requests into its ring caches of 825 and traces
``TICKS`` steps of ``make_serve_step`` after two untraced ones, once with
bf16 caches (K6 each layer) and once with int8 caches (K7).  With ``--train`` it builds the state, batches and step of
``chip_smoke.py``'s train phase, runs two steps untraced, then traces
``STEPS`` steps.  With ``--prefill`` it runs the serve phase's engine
once untraced (first-call set-up), then a second engine on the same
requests, traced until the last request is admitted; only the device
time inside the prefill batches (``ServeEngine._prefill``: connector,
wire, the server's forward, the KV scatter) is counted, grouped into the
connector (its record_function range), the wire's stats pass
(``rdfsq_stats``), K4, K5, K1, cuBLAS and the rest; ``--wire nf`` serves
through the NF-4 wire (blocks of 64, double quantization) instead of the
2-bit RD-FSQ one and splits the wire into K10, the double quantization
of the ranges (``ops.nf_quantize`` outside K10), the ranges' rebuild
(``ops.nf_dequantize`` outside K11) and K11.  All trace with
``torch.profiler`` (CPU + CUDA) and print one JSON object:

* the wall time per tick (step) and the device busy share (sum of kernel
  durations over the wall time; kernels run on one stream, so they do not
  overlap);
* kernel launches per tick (step) and the top kernels by device time;
* device time per tick (step) summed by group: each of the port's
  kernels, cuBLAS matrix products, and everything else (PyTorch's
  elementwise, copy and reduction kernels).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TICKS = 10
STEPS = 3
# kernel-name fragments (all present) -> group (the port's kernels by their
# K number; the four decode kernels are one template, told apart by its
# element type and address source)
GROUPS = ((("nf_quantize",), "K10 nf_quantize"),
          (("nf_dequantize",), "K11 nf_dequantize"),
          (("flash_fwd_kernel",), "K1 flash_fwd"),
          (("flash_bwd_dq_kernel",), "K2 flash_bwd_dq"),
          (("flash_bwd_dkv_kernel",), "K3 flash_bwd_dkv"),
          (("rdfsq_quantize",), "K4 rdfsq_quantize"),
          (("rdfsq_dequantize",), "K5 rdfsq_dequantize"),
          # the names of the first, scalar-only design
          (("::quantize_kernel<",), "K4 rdfsq_quantize"),
          (("::dequantize_kernel<",), "K5 rdfsq_dequantize"),
          (("paged_decode_kernel<__nv_bfloat16", "RingPages"), "K6 decode"),
          (("paged_decode_kernel<signed char", "RingPages"),
           "K7 decode_q8"),
          (("paged_decode_kernel<__nv_bfloat16", "TablePages"),
           "K8 decode_paged"),
          (("paged_decode_kernel<signed char", "TablePages"),
           "K9 decode_paged_q8"),
          (("wq_gemv_kernel",), "K12 wq_matmul"),
          (("wq_wgmma_kernel",), "K12 wq_matmul"),
          (("wq_matmul",), "K12 wq_matmul"),
          (("nvjet",), "cuBLAS GEMM"), (("gemm",), "cuBLAS GEMM"))


def _group(name: str) -> str:
    for frags, group in GROUPS:
        if all(frag in name for frag in frags):
            return group
    return "elementwise, copies, reductions"


def _trace(run_one, n: int, unit: str, card: str) -> dict:
    """Trace ``n`` calls of ``run_one`` (which returns False when there is
    nothing left to run) and summarize the device time per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    done = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while done < n and run_one():
            done += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if done == 0:
        raise RuntimeError(f"no {unit} left to trace")

    per_kernel = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            entry = per_kernel[ev.name]
            entry[0] += 1
            entry[1] += ev.time_range.elapsed_us()
    busy_us = sum(v[1] for v in per_kernel.values())
    launches = sum(v[0] for v in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    groups = defaultdict(float)
    for name, (_, us) in per_kernel.items():
        groups[_group(name)] += us / 1e3 / done
    return {
        "card": card, unit + "s": done,
        f"wall_ms_per_{unit}": 1e3 * wall / done,
        f"device_busy_ms_per_{unit}": busy_us / 1e3 / done,
        "device_busy_share": busy_us / 1e6 / wall,
        f"kernel_launches_per_{unit}": launches / done,
        f"device_ms_per_{unit}_by_group": dict(
            sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": name[:120],
                         f"launches_per_{unit}": k / done,
                         f"device_ms_per_{unit}": us / 1e3 / done}
                        for name, (k, us) in top]}


def profile_serve(chip_smoke, weight_quant=None, kv_bits=16) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("tinyllava"), kv_cache_bits=kv_bits)
    params = init_params(cfg, seed=0)
    reqs = chip_smoke._requests(cfg, 8, seed=7)
    need = sum(-(-(cfg.n_image_tokens + len(t) + m) // 16)
               for t, m, _ in reqs)
    eng = ServeEngine(params, cfg, n_slots=4, page_size=16,
                      n_pages=1 + need, split_wire=cfg.split.quant,
                      weight_quant=weight_quant)
    for t, m, img in reqs:
        eng.submit(t, max_new=m, image_embeds=img)
    while eng.scheduler.waiting:
        eng.step()
    eng.step()  # one more plain tick before tracing
    torch.cuda.synchronize()

    def tick() -> bool:
        if not eng.scheduler.active or eng.scheduler.waiting:
            return False
        eng.step()
        return True

    return _trace(tick, TICKS, "tick", chip_smoke.smi())


# a prefill range -> the group of the kernels inside it that are not one
# of the port's own (K10, K11)
RANGE_GROUPS = {"connector": "connector", "stats pass": "stats pass",
                "nf encode": "double quantization",
                "nf decode": "range rebuild"}


def profile_prefill(chip_smoke, wire: str = "rdfsq") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.core.quantizers import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import engine as engine_mod

    cfg = get_config("tinyllava")
    params = init_params(cfg, seed=0)
    reqs = chip_smoke._requests(cfg, 8, seed=7)
    need = sum(-(-(cfg.n_image_tokens + len(t) + m) // 16)
               for t, m, _ in reqs)
    split_wire = QuantConfig(method="nf", bits=4) if wire == "nf" \
        else cfg.split.quant

    def engine():
        eng = engine_mod.ServeEngine(params, cfg, n_slots=4, page_size=16,
                                     n_pages=1 + need,
                                     split_wire=split_wire)
        for t, m, img in reqs:
            eng.submit(t, max_new=m, image_embeds=img)
        return eng

    def ranged(fn, name):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    engine().run()  # first-call set-up untraced
    torch.cuda.synchronize()
    saved = (engine_mod.mlp_forward, ops.rdfsq_stats, ops.nf_quantize,
             ops.nf_dequantize)
    engine_mod.mlp_forward = ranged(engine_mod.mlp_forward, "connector")
    ops.rdfsq_stats = ranged(ops.rdfsq_stats, "stats pass")
    ops.nf_quantize = ranged(ops.nf_quantize, "nf encode")
    ops.nf_dequantize = ranged(ops.nf_dequantize, "nf decode")
    try:
        eng = engine()
        eng._prefill = ranged(eng._prefill, "prefill")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            while eng.scheduler.waiting:
                eng.step()
            torch.cuda.synchronize()
    finally:
        (engine_mod.mlp_forward, ops.rdfsq_stats, ops.nf_quantize,
         ops.nf_dequantize) = saved

    # the ranges as the profiler lays them on the device's timeline (each
    # from the first kernel launched inside it to the last one's end): a
    # kernel belongs to the ranges its start lies in
    labels = ("prefill", *RANGE_GROUPS)
    spans = {label: [] for label in labels}
    kernels = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.name in labels:
            spans[ev.name].append((ev.time_range.start, ev.time_range.end))
        else:
            kernels.append((ev.time_range.start, ev.name,
                            ev.time_range.elapsed_us()))

    def inside(t, label) -> bool:
        return any(a <= t <= b for a, b in spans[label])

    batches = len(spans["prefill"])
    if batches == 0:
        raise RuntimeError("no prefill batch was traced on the device")
    groups = defaultdict(float)
    launches = 0
    for t, name, us in kernels:
        if inside(t, "prefill"):
            launches += 1
            label = next((lab for lab in labels[1:] if inside(t, lab)), None)
            group = _group(name)
            if label and not group.startswith(("K10", "K11")):
                group = RANGE_GROUPS[label]
            groups[group] += us / 1e3
    stats = eng.stats
    return {"card": chip_smoke.smi(), "wire": wire,
            "prefill_batches": batches,
            "rows": stats["prefill_rows"],
            "wall_ms_per_prefill_batch":
                1e3 * stats["prefill_seconds"] / stats["prefill_batches"],
            "device_busy_ms_per_prefill_batch":
                sum(groups.values()) / batches,
            "kernel_launches_per_prefill_batch": launches / batches,
            "device_ms_per_prefill_batch_by_group": {
                g: ms / batches for g, ms in
                sorted(groups.items(), key=lambda kv: -kv[1])}}


def profile_generate(chip_smoke) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import decode as sd

    cfg = get_config("tinyllava")
    params = init_params(cfg, seed=0)
    b, text = chip_smoke.GEN_BATCH, chip_smoke.GEN_TEXT
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = dict(
        image_embeds=torch.randn((b, cfg.n_image_tokens, cfg.d_vision),
                                 generator=gen, device="cuda"),
        tokens=torch.randint(1, cfg.vocab_size, (b, text), generator=gen,
                             device="cuda"))
    cache_len = cfg.n_image_tokens + text + chip_smoke.GEN_NEW
    out = {}
    for bits in (16, 8):
        cfg_b = dataclasses.replace(cfg, kv_cache_bits=bits)
        logits, caches = sd.prefill(params, cfg_b, batch, cache_len)
        step = sd.make_serve_step(cfg_b)
        state = {"tok": logits[:, -1].argmax(dim=-1), "i": 0}

        def one() -> bool:
            qpos = torch.full((b,), cfg.n_image_tokens + text + state["i"],
                              dtype=torch.int32, device="cuda")
            logits, _ = step(params, caches,
                             dict(tokens=state["tok"][:, None]), qpos)
            state["tok"] = logits[:, -1].argmax(dim=-1)  # the next input
            state["i"] += 1
            return True

        for _ in range(2):  # first-call set-up untraced
            one()
        torch.cuda.synchronize()
        out[f"{bits}-bit caches"] = _trace(one, TICKS, "step",
                                           chip_smoke.smi())
    out["rows"], out["cache_len"] = b, cache_len
    return out


def profile_train(chip_smoke) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import init_state, make_train_step

    cfg = get_config("tinyllava")
    seq = cfg.n_image_tokens + chip_smoke.TRAIN_TEXT
    data = make_pipeline(cfg, chip_smoke.TRAIN_BATCH, seq, seed=0)
    opt = AdamWConfig(lr=1e-3)
    holder = {"state": init_state(cfg, opt, seed=0)}
    step_fn = make_train_step(cfg, opt, total_steps=chip_smoke.TRAIN_STEPS)
    batches = [next(data) for _ in range(2 + STEPS)]

    def step() -> bool:
        holder["state"], m = step_fn(holder["state"], batches.pop(0))
        float(m["loss"])  # the step's end, as the train phase reads it
        return True

    for _ in range(2):  # first-call set-up (cuBLAS, allocator) untraced
        step()
    torch.cuda.synchronize()
    out = _trace(step, STEPS, "step", chip_smoke.smi())
    out["positions_per_step"] = chip_smoke.TRAIN_BATCH * seq
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile full-width training steps instead of "
                           "decode ticks")
    mode.add_argument("--generate", action="store_true",
                      help="profile static decode steps over ring caches "
                           "instead of the engine's decode ticks")
    mode.add_argument("--prefill", action="store_true",
                      help="profile the engine's prefill batches instead "
                           "of its decode ticks")
    ap.add_argument("--weight-quant", choices=("int4", "int3"), default=None,
                    help="(decode ticks) serve RTN-quantized packed weights")
    ap.add_argument("--kv-bits", type=int, choices=(16, 8), default=16,
                    help="(decode ticks) bits of the engine's KV pools")
    ap.add_argument("--wire", choices=("rdfsq", "nf"), default="rdfsq",
                    help="(prefill batches) the split wire: the config's "
                         "2-bit RD-FSQ, or NF-4")
    ap.add_argument("--src", default=None,
                    help="profile the repro_torch of this tree (another "
                         "checkout's src/) instead of this checkout's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    if args.src:  # ahead of this checkout's src/, which chip_smoke added
        sys.path.insert(0, str(Path(args.src).resolve()))
        from repro_torch.kernels import build
        if not build.CSRC.is_relative_to(Path(args.src).resolve()):
            raise RuntimeError(f"repro_torch came from {build.CSRC}")
    if args.train:
        out = profile_train(chip_smoke)
    elif args.generate:
        out = profile_generate(chip_smoke)
    elif args.prefill:
        out = profile_prefill(chip_smoke, args.wire)
    else:
        out = profile_serve(chip_smoke, args.weight_quant, args.kv_bits)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
