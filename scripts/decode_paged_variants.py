#!/usr/bin/env python3
"""Where the decode kernels (``csrc/decode_paged.cu``: K6 / K7 over ring
caches, K8 / K9 over paged pools) spend their time: device time at the
generate and serve shapes under other cluster sizes and under timing-only
edits of the source.

    python3 scripts/decode_paged_variants.py

Needs one CUDA device and nvcc.  On ``chip_smoke.py``'s serve-shaped
paged case (4 active slots of 760 - 860 tokens, 5 kv heads, G 4, 64
table entries of 16-token pages) it times K8 and K9, and on its
generate-shaped ring case (B 4, L 825, 5 kv heads, G 4) K6 and K7, by
CUDA-graph replay (``chip_smoke.time_graph_ms``), in the order given,
then in reverse, so that drift shows:

* ``c8`` / ``c4`` / ``c2`` / ``c1``: the kernels as built, with clusters
  of at most 8, 4, 2 or 1 blocks (``attention_ops.PAGED_MAX_CLUSTER``
  overridden; K8 / K9 8, 16, 32 or 64 pages a rank, K6 / K7 7, 13, 26 or
  52 virtual pages);
* ``empty``: every block returns at once: the launch of the clusters;
* ``nocompute``: no products or softmax (the scan, the copies, the
  combine stay);
* ``nocopy``: no K / V copies (the products read whatever shared memory
  holds);
* ``nodsmem``: each rank combines only its own partial, with block
  barriers in place of the two cluster barriers.

The edited variants compute garbage (their error against the plain
version is printed) and exist only to be timed; each is built into its
own library under ``build/decode_paged_variants/``.  One line per run:
the variant, K8, K9, K6 and K7 ms, and max |out - plain| of each.
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
    "empty": [("  using R = Rows<Elem, D>;\n",
               "  using R = Rows<Elem, D>;\n  if (npp > 0) return;\n")],
    "nocompute": [("for (int chunk = warp; chunk < nch;",
                   "for (int chunk = warp; chunk < 0;")],
    "nocopy": [("      cp_async16(dst, src, v);\n", "")],
    "nodsmem": [("  hopper::cluster_arrive(true);\n  hopper::cluster_wait();",
                 "  __syncthreads();"),
                ("cluster.map_shared_rank(bm, r)", "bm"),
                ("  hopper::cluster_arrive(false);\n  hopper::cluster_wait();",
                 "  __syncthreads();")],
}
CLUSTERS = {"c8": 8, "c4": 4, "c2": 2, "c1": 1}
ORDER = ["c8", "c4", "c2", "c1", "empty", "nocompute", "nocopy", "nodsmem"]
FNS = ("decode_paged_bf16", "decode_paged_q8", "decode_bf16", "decode_q8")


def _variant_libs(build) -> dict:
    """Build every edited variant, one nvcc each, all started together."""
    out = ROOT / "build" / "decode_paged_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        src = (build.CSRC / "decode_paged.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in decode_paged.cu")
            src = src.replace(old, new)
        cu, so = out / f"decode_paged_{name}.cu", out / f"lib_{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in FNS:
            getattr(lib, fn).argtypes = build._ARGTYPES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_paged_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import attention_ops, attention_ref, build

    print(cs.smi())
    libs = {name: build.library() for name in CLUSTERS}
    libs.update(_variant_libs(build))
    gen = torch.Generator(device="cuda").manual_seed(1234)
    qf, k, v, q8, pos, pt, qpos = cs._paged_case(gen, (857, 790, 823, 761))
    ref8 = attention_ref.decode_attention_paged_ref(qf, k, v, pos, pt, qpos)
    ref9 = attention_ref.decode_attention_paged_q8_ref(qf, *q8, pos, pt,
                                                       qpos)
    rq, rk, rv, r8, kpos, rpos = cs._ring_case(gen, 4, 825,
                                                [824, 792, 500, 100])
    kernels = {
        "K8": (lambda: attention_ops.decode_paged(qf, k, v, pos, pt, qpos),
               ref8),
        "K9": (lambda: attention_ops.decode_paged_q8(qf, *q8, pos, pt,
                                                     qpos), ref9),
        "K6": (lambda: attention_ops.decode(rq, rk, rv, kpos, rpos),
               attention_ref.decode_attention_ref(rq, rk, rv, kpos, rpos)),
        "K7": (lambda: attention_ops.decode_q8(rq, *r8, kpos, rpos),
               attention_ref.decode_attention_q8_ref(rq, *r8, kpos, rpos)),
    }

    for name in ORDER + ORDER[::-1]:
        build._lib = libs[name]
        attention_ops.PAGED_MAX_CLUSTER = CLUSTERS.get(name, 8)
        attention_ops.decode_paged_plan.cache_clear()
        errs = {tag: cs.max_err(fn(), ref)
                for tag, (fn, ref) in kernels.items()}
        times = {tag: cs.time_graph_ms(fn, 16)
                 for tag, (fn, _) in kernels.items()}
        print(f"{name:9s} " + ", ".join(
            f"{tag} {times[tag]:.4f} ms" for tag in kernels)
            + "; errors " + " ".join(f"{errs[tag]:.1e}" for tag in kernels),
            flush=True)
    attention_ops.PAGED_MAX_CLUSTER = 8
    attention_ops.decode_paged_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
