#!/usr/bin/env python3
"""Build the kernels, then run the named checks and phases of
``chip_smoke.py`` alone, each step on its own.

    python3 scripts/smoke_phases.py [--log PATH] NAME [NAME ...]

Names, run in the order given:

* ``flash64``, ``flash128``, ``flash96``, ``flash192``, ``flash80``: K1
  and K2 / K3 against their plain versions at (D, Dv) = (64, 64),
  (128, 128), (96, 64), (192, 128) or (80, 80), timed; ``flash64g1`` at
  (64, 64) at musicgen_large's G 1 (rows ``*_d64g1``);
* ``wire`` (K4 / K5), ``nf`` (K10 / K11), ``wq`` (K12), ``ring64`` /
  ``ring128`` / ``ring80`` / ``ring64g1`` (K6 / K7) and ``paged64`` /
  ``paged128`` / ``paged80`` (K8 / K9) likewise;
  ``kernels`` all of them, as the smoke's kernels phase;
* ``tinyllava`` (phases 3 - 12), and any phase by the name after
  ``phase_`` in ``chip_smoke.py``: ``pipeline``, ``lora_pipeline``,
  ``hub``, ``hub_async``, ``hub_lora``, ``serve_llama``, ``granite``,
  ``zoo_wide``, ``mla``, ``attack``, ``arctic_serve``, ``arctic_train``,
  ``deepseek_serve``, ``deepseek_train``, ``zamba2_serve``,
  ``zamba2_train``, ``rwkv6_serve``, ``rwkv6_train``, ``musicgen_serve``,
  ``musicgen_train``, ``paper`` (Tables 1 - 4, the roofline's counts and
  the adaptive-wire curve at full-width tinyllava), ``quickstart``.

Needs one CUDA device and nvcc.  A step that fails prints its traceback
and the next one runs; the exit code is 1 if any failed (or a name is
unknown).  Each step prints its seconds and peak device memory, a phase
its launch counts; with ``--log`` the output is also written to PATH.
The last line is the card's name and power limit.
"""
import gc
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# flashW -> (D, Dv) of check_flash / check_flash_bwd; flash64g1 at
# musicgen_large's G 1
FLASH = {"flash64": (64, None), "flash128": (128, None),
         "flash96": (96, 64), "flash192": (192, 128), "flash80": (80, 80),
         "flash64g1": (64, None)}
# the other kernel checks: name -> (function of chip_smoke, keywords)
CHECKS = {"wire": ("check_wire", {}), "nf": ("check_nf", {}),
          "wq": ("check_wq", {}),
          "ring64": ("check_ring_decode", {}),
          "ring128": ("check_ring_decode", {"d": 128}),
          "ring80": ("check_ring_decode", {"d": 80}),
          "ring64g1": ("check_ring_decode", {"g1": True}),
          "paged64": ("check_decode", {}),
          "paged128": ("check_decode", {"d": 128}),
          "paged80": ("check_decode", {"d": 80})}


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
    """``fn(*args, **kw)``, its seconds and peak device memory printed; a
    failure prints its traceback.  Returns (ok, result)."""
    import torch

    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        print(f"== {name} ok {time.perf_counter() - t0:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        return True, out
    except Exception:
        traceback.print_exc()
        print(f"== {name} FAILED {time.perf_counter() - t0:.1f} s",
              flush=True)
        return False, None


def _runs(cs, name, gen, results):
    """The (label, function, arguments) steps of one name; KeyError for an
    unknown one."""
    if name in FLASH:
        d, dv = FLASH[name]
        kw = {"d": d, "dv": dv, "g1": name.endswith("g1")}
        return [(f"K1 {name}", cs.check_flash, (gen, results), kw),
                (f"K2/K3 {name}", cs.check_flash_bwd, (gen, results), kw)]
    if name in CHECKS:
        fn, kw = CHECKS[name]
        return [(name, getattr(cs, fn), (gen, results), kw)]
    if name == "kernels":
        return [(name, cs.phase_kernels, (), {})]
    if name == "tinyllava":
        return [(name, cs.run_tinyllava, (), {})]
    fn = getattr(cs, f"phase_{name}", None)
    if fn is None or name == "build":
        raise KeyError(name)
    return [(name, fn, (), {})]


def main(argv) -> int:
    import torch

    log_path = None
    if argv[:1] == ["--log"]:
        log_path, argv = Path(argv[1]), argv[2:]
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    try:
        plan = [r for name in argv for r in _runs(cs, name, gen, results)]
    except KeyError as e:
        print(f"smoke_phases: unknown name {e}", file=sys.stderr)
        return 1
    if log_path is not None:
        log_path.parent.mkdir(parents=True, exist_ok=True)
        log = open(log_path, "w")
        sys.stdout = _Tee(sys.__stdout__, log)
        sys.stderr = _Tee(sys.__stderr__, log)
    ok, _ = step("build", cs.phase_build)
    failed = [] if ok else ["build"]
    for label, fn, args, kw in plan if ok else ():
        good, out = step(label, fn, *args, **kw)
        if not good:
            failed.append(label)
        if isinstance(out, dict) and fn is not cs.phase_kernels:
            for path, launches in out.items():
                if isinstance(launches, dict):
                    print(f"[launches] {path}: {launches}")
        gc.collect()
        torch.cuda.empty_cache()
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[kernels] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, library {lib} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), max abs err {r['max_abs_err']:.3e}")
    if failed:
        print(f"smoke_phases: failed: {', '.join(failed)}")
    print(cs.smi())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
