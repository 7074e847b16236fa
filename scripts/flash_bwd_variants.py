#!/usr/bin/env python3
"""Where K2 / K3 (``csrc/flash_bwd.cu``) spend their time: device time at
the training shape under other launch plans and under timing-only edits
of the source.

    python3 scripts/flash_bwd_variants.py

Needs one CUDA device and nvcc.  At ``chip_smoke.py``'s training shape
(B 4, 20 / 5 heads, 793 positions padded to 1 024, D 64) it times K2 and
K3 by CUDA-graph replay (``chip_smoke.time_graph_ms``), in the order
given, then in reverse, so that drift shows:

* ``p1`` / ``p2`` / ``p4``: the kernels as built, with 1, 2 or 4 query
  heads per block (``attention_ops.bwd_heads_per_block`` overridden);
* ``noloop``: no main loop (every block lists its tiles, makes its first
  loads and writes its output): a block's fixed cost;
* ``noexp``: the exponential replaced by its argument;
* ``nowgmma``: every wgmma product removed;
* ``stages5``: five ring stages instead of three.

The edited variants compute garbage (their error against the plain
version is printed) and exist only to be timed; each is built into its
own library under ``build/flash_bwd_variants/``.  One line per run:
the variant, K2 and K3 ms, their sum, and max |x - plain| / max |plain|
of dq, dk, dv.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# source edits of the timing-only variants: (old, new) replacements
EDITS = {
    "noloop": [("const int n_vis = red[4];", "const int n_vis = 0;"),
               ("total = gpb * n_list;", "total = 0;")],
    "noexp": [("flash::exp2_approx(", "(")],
    "nowgmma": [("namespace {\n\nnamespace cg",
                 "template <class... A>\n__device__ __forceinline__ void "
                 "nop_mma(A&&...) {}\nnamespace {\n\nnamespace cg"),
                ("hopper::wgmma_m64n64_ss<0>(", "nop_mma("),
                ("flash::mma_mn<D>(", "nop_mma("),
                ("flash::mma_mn<DV>(", "nop_mma(")],
    "stages5": [("constexpr int kStages = 3;", "constexpr int kStages = 5;")],
}
HEADS = {"p1": 1, "p2": 2, "p4": 4}
ORDER = ["p1", "p2", "p4", "noloop", "noexp", "nowgmma", "stages5"]


def _variant_lib(build, name: str, edits) -> ctypes.CDLL:
    src = (build.CSRC / "flash_bwd.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in flash_bwd.cu")
        src = src.replace(old, new)
    out = ROOT / "build" / "flash_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"flash_bwd_{name}.cu", out / f"lib_{name}.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-shared", "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        getattr(lib, fn).argtypes = build._ARGTYPES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import attention_ops, attention_ref, build

    print(cs.smi())
    libs = {name: build.library() for name in HEADS}
    libs.update({name: _variant_lib(build, name, e)
                 for name, e in EDITS.items()})
    plan_rule = attention_ops.bwd_heads_per_block
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q, k, v, qpos, kpos, _ = cs._flash_case(gen, 4, 793, 20, 5)
    out, m, l = attention_ops.flash_forward(q, k, v, qpos, kpos)
    out = out.bfloat16()
    go = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
    go = go * (l > 0)
    di = (go.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, go, m, l, di, qpos, kpos)
    ref = attention_ref.flash_backward_ref(*args)
    for name in ORDER + ORDER[::-1]:
        build._lib = libs[name]
        p = HEADS.get(name)
        attention_ops.bwd_heads_per_block = (
            plan_rule if p is None else (lambda *a, p=p, **kw: p))
        attention_ops.BWD_STAGES = 5 if name == "stages5" else 3
        attention_ops.flash_bwd_plan.cache_clear()
        dq = attention_ops.flash_backward_dq(*args)
        dk, dv = attention_ops.flash_backward_dkv(*args)
        torch.cuda.synchronize()
        errs = [cs.max_err(a, r) / float(r.abs().max())
                for a, r in zip((dq, dk, dv), ref)]
        t2 = cs.time_graph_ms(lambda: attention_ops.flash_backward_dq(*args),
                              8)
        t3 = cs.time_graph_ms(
            lambda: attention_ops.flash_backward_dkv(*args), 8)
        print(f"{name:8s} K2 {t2:.4f} ms, K3 {t3:.4f} ms, sum {t2 + t3:.4f} "
              "ms; errors " + " ".join(f"{e:.1e}" for e in errs), flush=True)
    attention_ops.bwd_heads_per_block = plan_rule
    attention_ops.BWD_STAGES = 3
    attention_ops.flash_bwd_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
