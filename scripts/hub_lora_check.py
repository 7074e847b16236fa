#!/usr/bin/env python3
"""Build the kernels and run ``chip_smoke.py``'s hub lora phase alone, after
K12's check (its llama server-stage shapes included); with ``--sweep`` first
train the phase's SplitLoRA hub at lr 1e-2, 3e-3 and 1e-3 (the phase runs
``chip_smoke.HUB_LORA_LR``): for each, from the same fresh adapters, the
lockstep steps and then the async ticks, printing the first batch's loss
before and after each, the lr's yardstick.  ``--probe LR`` first runs the
same lockstep steps and async ticks at ``LR``, the ticks one by one with
each tick's raw adapter gradients beside them, and prints per tick the
loss, the largest |gradient| of the server and of each client (fp16, the
codec's lo / hi, ends at 65 504) and the non-finite counts of the
gradients and the adapters, stopping at the first non-finite one.

    python3 scripts/hub_lora_check.py [--sweep] [--probe LR]

Needs one CUDA device and nvcc; about 5 minutes of command time with
``--sweep``.  Prints what the phase prints, its launches by path, and the
card's name and power limit.
"""
import dataclasses
import gc
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def sweep(lrs):
    import torch
    from repro_torch.core.quantizers import QuantConfig
    from repro_torch.core.split import HubConfig
    from repro_torch.launch import split_hub as sh
    from repro_torch.launch import split_pipeline as sp
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils.tree import tree_leaves

    cfg = sp._homogeneous_cfg("llama3_2_3b", n_stages=2)
    n, n_micro, mb, seq = cs.HUB_CLIENTS, cs.HUB_MICRO, cs.PIPE_MB, \
        cs.PIPE_SEQ
    hub = HubConfig(n_clients=n, client_quants=sh.hub_quants(n),
                    grad_quant=sh.GRAD_QUANT)
    hub_a = dataclasses.replace(
        hub, bwd_quant=QuantConfig(method="rdfsq", bits=2),
        tick_rates=cs.HUB_LORA_RATES)
    params = sh.init_hub_params(cfg, hub, seed=0, lora_rank=cs.LORA_RANK)
    fresh = cs._tree(params["adapters"], lambda t: t.clone())
    lock = [(torch.as_tensor(t).cuda(), torch.as_tensor(lab).cuda())
            for t, lab in sh.make_batches(cfg, cs.HUB_STEPS, n_micro, n, mb,
                                          seq)]
    ticks = [(torch.as_tensor(t[0]).cuda(), torch.as_tensor(lab[0]).cuda())
             for t, lab in sh.make_batches(cfg, cs.HUB_LORA_TICKS, 1, n, mb,
                                           seq, seed=1)]
    first_lock = (lock[0][0][:1], lock[0][1][:1])
    first_tick = (ticks[0][0][None], ticks[0][1][None])
    for lr in lrs:
        for a, b in zip(tree_leaves(params["adapters"]), tree_leaves(fresh)):
            a.copy_(b)
        opt = AdamWConfig(lr=lr, weight_decay=0.0)
        t0 = time.perf_counter()
        b0 = cs._lora_hub_loss(cfg, hub, params, first_lock)
        out = sh.train_hub(cfg, hub, opt, lock, micro_batch=mb, seq=seq,
                           n_micro=n_micro, params=params,
                           lora_rank=cs.LORA_RANK)
        a0 = cs._lora_hub_loss(cfg, hub, params, first_lock)
        b1 = cs._lora_hub_loss(cfg, hub_a, params, first_tick)
        out_a = sh.train_hub(cfg, hub_a, opt, ticks, micro_batch=mb,
                             seq=seq, mode="async",
                             n_ticks=cs.HUB_LORA_TICKS, params=params,
                             lora_rank=cs.LORA_RANK)
        a1 = cs._lora_hub_loss(cfg, hub_a, params, first_tick)
        print(f"[sweep lr {lr}] lockstep: first batch {b0:.4f} -> "
              f"{a0:.4f}, history {[round(v, 4) for v in out['history']]}; "
              f"async: first tick's batch {b1:.4f} -> {a1:.4f}, history "
              f"{[round(v, 4) for v in out_a['history']]}; "
              f"{time.perf_counter() - t0:.1f} s")
        del out, out_a
        gc.collect()
        torch.cuda.empty_cache()
    del params, fresh, lock, ticks
    gc.collect()
    torch.cuda.empty_cache()


def probe(lr):
    import torch
    from repro_torch.core.quantizers import QuantConfig
    from repro_torch.core.split import HubConfig
    from repro_torch.launch import schedules
    from repro_torch.launch import split_hub as sh
    from repro_torch.launch import split_pipeline as sp
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils.tree import tree_leaves

    cfg = sp._homogeneous_cfg("llama3_2_3b", n_stages=2)
    n, n_micro, mb, seq = cs.HUB_CLIENTS, cs.HUB_MICRO, cs.PIPE_MB, \
        cs.PIPE_SEQ
    hub = HubConfig(n_clients=n, client_quants=sh.hub_quants(n),
                    grad_quant=sh.GRAD_QUANT)
    hub_a = dataclasses.replace(
        hub, bwd_quant=QuantConfig(method="rdfsq", bits=2),
        tick_rates=cs.HUB_LORA_RATES)
    params = sh.init_hub_params(cfg, hub, seed=0, lora_rank=cs.LORA_RANK)
    opt = AdamWConfig(lr=lr, weight_decay=0.0)
    lock = [(torch.as_tensor(t).cuda(), torch.as_tensor(lab).cuda())
            for t, lab in sh.make_batches(cfg, cs.HUB_STEPS, n_micro, n, mb,
                                          seq)]
    sh.train_hub(cfg, hub, opt, lock, micro_batch=mb, seq=seq,
                 n_micro=n_micro, params=params, lora_rank=cs.LORA_RANK)
    ticks = [(torch.as_tensor(t[0]).cuda(), torch.as_tensor(lab[0]).cuda())
             for t, lab in sh.make_batches(cfg, cs.HUB_LORA_TICKS, 1, n, mb,
                                           seq, seed=1)]
    state = schedules.init_hub_state(cfg, hub_a, opt, params=params,
                                     lora_rank=cs.LORA_RANK)
    grad_step = schedules.build_async_grad_step(cfg, hub_a, mb, seq,
                                                cs.LORA_RANK)
    update = schedules.build_async_update(cfg, hub_a, opt, mb, seq,
                                          lora_rank=cs.LORA_RANK)

    def top(tree):
        return max(float(t.float().abs().max()) for t in tree_leaves(tree))

    def bad(tree):
        return sum(int((~torch.isfinite(t)).sum()) for t in tree_leaves(tree))

    for t, mask, (tok, lab) in schedules.async_tick_stream(
            ticks, cs.HUB_LORA_RATES, cs.HUB_LORA_TICKS):
        _, _, grads, _, _ = grad_step(
            state["server"].params, state["client_params"], tok, lab, mask,
            state["client_adapters"])
        state, m = update(state, tok, lab, mask)
        n_bad = (bad(grads), bad(state["client_adapters"])
                 + bad(state["server"].params["adapters"]))
        print(f"[probe lr {lr}] tick {t} arrivals {mask.astype(int).tolist()}"
              f": loss {float(m['loss']):.4f}, max |grad| server "
              f"{top(grads['server']):.4g}, clients "
              f"{[round(top(g), 4) for g in grads['clients'].values()]}; "
              f"non-finite gradients {n_bad[0]}, adapters {n_bad[1]}")
        del grads
        if any(n_bad) or not math.isfinite(float(m["loss"])):
            break
    del state, params, lock, ticks
    gc.collect()
    torch.cuda.empty_cache()


def k12():
    import torch

    results = {}
    cs.check_wq(torch.Generator(device="cuda").manual_seed(1234), results)


cs._timed("build", cs.phase_build)
cs._timed("K12", k12)
if "--probe" in sys.argv:
    cs._timed("probe", probe, float(sys.argv[sys.argv.index("--probe") + 1]))
if "--sweep" in sys.argv:
    cs._timed("sweep", sweep, (1e-2, 3e-3, 1e-3))
paths = cs._timed("hub lora", cs.phase_hub_lora)
for path, launches in paths.items():
    print(f"[launches] {path}: {launches}")
print(cs.smi())
