#!/usr/bin/env python3
"""Build the kernels and run ``chip_smoke.py``'s hub async phase alone; with
``--sweep`` first train the phase's async hub for its 18 ticks at lr 1e-4
and 1e-3 (the phase runs 3e-4) and print the first tick's batch's loss
before and after, the lr's yardstick.

    python3 scripts/hub_async_check.py [--sweep]

Needs one CUDA device and nvcc; about 2 minutes of command time with
``--sweep``.  Prints what the phase prints, its launches by path, and the
card's name and power limit.
"""
import dataclasses
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def sweep(lr):
    import torch
    from repro_torch.core.quantizers import QuantConfig
    from repro_torch.core.split import HubConfig
    from repro_torch.launch import split_hub as sh
    from repro_torch.launch import split_pipeline as sp
    from repro_torch.optim import AdamWConfig

    full = sp._homogeneous_cfg("llama3_2_3b", n_stages=2)
    cfg = dataclasses.replace(full, n_layers=cs.HUB_LAYERS)
    n, mb, seq = cs.HUB_CLIENTS, cs.PIPE_MB, cs.PIPE_SEQ
    hub = HubConfig(n_clients=n, client_quants=sh.hub_quants(n),
                    bwd_quant=QuantConfig(method="rdfsq", bits=2),
                    tick_rates=cs.ASYNC_RATES)
    params = sh.init_hub_params(cfg, hub, seed=0)
    batches = [(torch.as_tensor(t[0]).cuda(),
                torch.as_tensor(lab[0]).cuda())
               for t, lab in sh.make_batches(cfg, cs.ASYNC_TICKS, 1, n, mb,
                                           seq)]

    def first():
        with torch.no_grad():
            return float(sh.build_hub_step(cfg, hub, 1, mb, seq)(
                params, batches[0][0][None], batches[0][1][None])[0])

    before = first()
    t0 = time.perf_counter()
    out = sh.train_hub(cfg, hub, AdamWConfig(lr=lr, weight_decay=0.0),
                       batches, micro_batch=mb, seq=seq, mode="async",
                       n_ticks=cs.ASYNC_TICKS, params=params)
    secs = time.perf_counter() - t0
    after = first()
    print(f"[sweep lr {lr}] first batch {before:.4f} -> {after:.4f}; "
          f"history {[round(v, 4) for v in out['history']]}; {secs:.1f} s")
    del out, params, batches
    gc.collect()
    torch.cuda.empty_cache()


cs._timed("build", cs.phase_build)
if "--sweep" in sys.argv:
    for lr in (1e-4, 1e-3):
        sweep(lr)
paths = cs._timed("hub async", cs.phase_hub_async)
for path, launches in paths.items():
    print(f"[launches] {path}: {launches}")
print(cs.smi())
