#!/usr/bin/env python3
"""Where a decode tick of the port's split-serve engine, or a training
step, spends its time.

    python3 scripts/profile_torch_serve.py            # decode ticks
    python3 scripts/profile_torch_serve.py --train    # training steps

Needs one CUDA device.  Without ``--train`` it builds the same full-width
tinyllava engine and requests as ``chip_smoke.py``'s serve phase, steps it
until every request has been admitted (so no prefill runs afterwards),
then traces ``TICKS`` pure decode ticks.  With ``--train`` it builds the
state, batches and step of ``chip_smoke.py``'s train phase, runs two
steps untraced, then traces ``STEPS`` steps.  Both trace with
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
# kernel-name fragment -> group (the port's kernels by their K number)
GROUPS = (("flash_fwd_kernel", "K1 flash_fwd"),
          ("flash_bwd_dq_kernel", "K2 flash_bwd_dq"),
          ("flash_bwd_dkv_kernel", "K3 flash_bwd_dkv"),
          ("rdfsq", "K4/K5 rdfsq"), ("decode_paged_kernel", "K8 decode_paged"),
          ("nvjet", "cuBLAS GEMM"), ("gemm", "cuBLAS GEMM"))


def _group(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
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
        "top_kernels": [{"name": name[:90],
                         f"launches_per_{unit}": k / done,
                         f"device_ms_per_{unit}": us / 1e3 / done}
                        for name, (k, us) in top]}


def profile_serve(chip_smoke) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("tinyllava")
    params = init_params(cfg, seed=0)
    reqs = chip_smoke._requests(cfg, 8, seed=7)
    need = sum(-(-(cfg.n_image_tokens + len(t) + m) // 16)
               for t, m, _ in reqs)
    eng = ServeEngine(params, cfg, n_slots=4, page_size=16,
                      n_pages=1 + need, split_wire=cfg.split.quant)
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
    ap.add_argument("--train", action="store_true",
                    help="profile full-width training steps instead of "
                         "decode ticks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    out = profile_train(chip_smoke) if args.train \
        else profile_serve(chip_smoke)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
