#!/usr/bin/env python3
"""Where a decode tick of the port's split-serve engine spends its time.

    python3 scripts/profile_torch_serve.py

Needs one CUDA device.  Builds the same full-width tinyllava engine and
requests as ``chip_smoke.py``'s serve phase, steps it until every request
has been admitted (so no prefill runs afterwards), then traces
``TICKS`` pure decode ticks with ``torch.profiler`` (CPU + CUDA).
Prints one JSON object:

* the wall time per tick and the device busy share (sum of kernel
  durations over the wall time; kernels run on one stream, so they do not
  overlap);
* kernel launches per tick and the top kernels by device time.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TICKS = 10


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
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

    ticks = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while ticks < TICKS and eng.scheduler.active \
                and not eng.scheduler.waiting:
            eng.step()
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if ticks == 0:
        raise RuntimeError("no decode tick left to trace")

    per_kernel = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            entry = per_kernel[ev.name]
            entry[0] += 1
            entry[1] += ev.time_range.elapsed_us()
    busy_us = sum(v[1] for v in per_kernel.values())
    launches = sum(v[0] for v in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    out = dict(
        card=chip_smoke.smi(), ticks=ticks,
        wall_ms_per_tick=1e3 * wall / ticks,
        device_busy_ms_per_tick=busy_us / 1e3 / ticks,
        device_busy_share=busy_us / 1e6 / wall,
        kernel_launches_per_tick=launches / ticks,
        top_kernels=[dict(name=name[:90], launches_per_tick=n / ticks,
                          device_ms_per_tick=us / 1e3 / ticks)
                     for name, (n, us) in top])
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
