#!/usr/bin/env python3
"""The attack and arctic parts of ``chip_smoke.py`` alone, each step on
its own.

    python3 scripts/attack_moe_check.py [flash] [attack] [serve] [train]

Needs one CUDA device and nvcc.  Builds the kernels, with ``flash`` holds
K1 - K3 at head width 128 (the G 4 / G 7 cases among them), then runs the
smoke's ``attack``, ``arctic serve`` and ``arctic train`` phases, or those
named.  A step that fails prints its traceback and the next one runs.
The output is also written to ``chiprun_out/attack_moe_check.log``.
"""
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

from zoo_check import _Tee, step  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attack_moe_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    log = open(ROOT / "chiprun_out" / "attack_moe_check.log", "w")
    sys.stdout = _Tee(sys.__stdout__, log)
    sys.stderr = _Tee(sys.__stderr__, log)
    only = sys.argv[1:]
    print(cs.smi())
    step("build", cs.phase_build)
    if "flash" in only:
        gen = torch.Generator(device="cuda").manual_seed(1234)
        res = {}
        step("K1 128", cs.check_flash, gen, res, d=128)
        step("K2/K3 128", cs.check_flash_bwd, gen, res, d=128)
        for name, r in res.items():
            print(name, r)
    for name, fn in (("attack", cs.phase_attack),
                     ("serve", cs.phase_arctic_serve),
                     ("train", cs.phase_arctic_train)):
        if not [a for a in only if a != "flash"] or name in only:
            out = step(name, fn)
            print(f"== {name} launches {out}")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
