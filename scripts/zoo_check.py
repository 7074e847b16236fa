#!/usr/bin/env python3
"""The arch zoo's parts of ``chip_smoke.py`` alone, each step on its own.

    python3 scripts/zoo_check.py [quick] [granite] [wide] [mla]

Needs one CUDA device and nvcc.  Builds the kernels, holds K1 - K3 at
(D, Dv) = (96, 64) and at 128 (the G 4 / G 7 cases timed), and without
``quick`` also at 64 and K6 - K9 at 128 (G 7 among them); then runs the
smoke's ``granite``, ``33b / 34b`` (``wide``) and ``mla`` phases, or
those named.  A step that fails prints its traceback and the next one
runs.  The output is also written to ``chiprun_out/zoo_check.log``.
"""
import gc
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


class _Tee:
    def __init__(self, *files):
        self.files = files

    def write(self, x):
        for f in self.files:
            f.write(x)

    def flush(self):
        for f in self.files:
            f.flush()


def step(name, fn, *args, **kw):
    import torch

    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        print(f"== {name} ok {time.perf_counter() - t0:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        return out
    except Exception:
        traceback.print_exc()
        print(f"== {name} FAILED {time.perf_counter() - t0:.1f} s",
              flush=True)
        return None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("zoo_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    log = open(ROOT / "chiprun_out" / "zoo_check.log", "w")
    sys.stdout = _Tee(sys.__stdout__, log)
    sys.stderr = _Tee(sys.__stderr__, log)
    quick = "quick" in sys.argv
    only = [a for a in sys.argv[1:] if a != "quick"]
    print(cs.smi())
    step("build", cs.phase_build)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {}
    widths = [(96, 64), (128, None)] + ([] if quick else [(64, None)])
    for d, dv in widths:
        step(f"K1 {d}", cs.check_flash, gen, res, d=d, dv=dv)
        step(f"K2/K3 {d}", cs.check_flash_bwd, gen, res, d=d, dv=dv)
    if not quick:
        step("K6/K7 128", cs.check_ring_decode, gen, res, d=128)
        step("K8/K9 128", cs.check_decode, gen, res, d=128)
    for name, r in res.items():
        print(name, r)
    for name, fn in (("granite", cs.phase_granite),
                     ("wide", cs.phase_zoo_wide), ("mla", cs.phase_mla)):
        if not only or name in only:
            step(name, fn)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
