#!/usr/bin/env python3
"""Device time of the RD-FSQ wire kernels (K4 quantize + pack, K5 unpack +
dequantize) of one checkout, for comparing two checkouts on one card.

    python3 scripts/wire_ab.py [--src DIR] [--tag NAME]

Needs one CUDA device and nvcc.  Imports ``repro_torch`` from DIR (by
default this checkout's ``src/``), builds that tree's kernels into its own
``build/``, and times K4 and K5 at 2 bits in bf16 at the serve shape (4 x
933 120 values: 729 image tokens x 1280 channels) and at the adaptive
wire's group shape (4 x 116 640: 729 x 160), by CUDA-graph replay of 32
calls (median of 15 replays) two ways: warm (one input, L2-resident;
``chip_smoke.time_graph_ms``) and cold (8 inputs in rotation, every
output a buffer of its own; ``chip_smoke.time_graph_cold_ms``).

The inputs come from fixed seeds, so two trees see the same data.  Prints
the card's name and power limit, then one JSON line: the tag, the
kernels' ms and each output's max |out - plain|.  To compare two trees,
run it from both in turns (A, B, B, A) in one call on one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {"serve shape": (4, 729 * 1280), "group shape": (4, 729 * 160)}
BITS, COLD, CALLS = 2, 8, 32


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wire_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs  # puts this checkout's src/ on the path

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import rdfsq_stats

    if not build.CSRC.is_relative_to(Path(args.src).resolve()):
        raise RuntimeError(f"repro_torch came from {build.CSRC}")
    print(cs.smi())
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = {"tag": args.tag, "ms": {}, "max_abs_err": {}}
    for label, (r, c) in SHAPES.items():
        k4, k5 = [], []
        for _ in range(COLD):
            x = (torch.randn((r, c), generator=gen, device="cuda") * 0.7
                 + 0.1).bfloat16()
            x[0, :7] = 25.0
            lo, hi = rdfsq_stats(x)
            stats = torch.cat([lo, hi], 1).float()
            k4.append((x, stats))
            k5.append((ops.quantize_plain(x, stats, BITS).contiguous(),
                       stats.half().float()))

        def q(x, stats):
            return ops.quantize_kernel(x, stats, BITS)

        def d(words, st16, c=c):
            return ops.dequantize_kernel(words, st16, BITS, c,
                                         torch.bfloat16)

        refs = (ops.quantize_plain(*k4[0], BITS),
                ops.dequantize_plain(*k5[0], BITS, c, torch.bfloat16))
        for tag, fn, inputs, ref in (("K4", q, k4, refs[0]),
                                     ("K5", d, k5, refs[1])):
            out["max_abs_err"][f"{tag} {label}"] = cs.max_err(
                fn(*inputs[0]), ref)
            out["ms"][f"{tag} {label} warm"] = cs.time_graph_ms(
                lambda: fn(*inputs[0]), CALLS)
            out["ms"][f"{tag} {label} cold"] = cs.time_graph_cold_ms(
                fn, inputs * (CALLS // COLD))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
