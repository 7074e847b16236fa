#!/usr/bin/env python3
"""Device time of the four decode kernels (K6 - K9) of one checkout, for
comparing two checkouts on one card.

    python3 scripts/decode_ab.py [--src DIR] [--tag NAME]

Needs one CUDA device and nvcc.  Imports ``repro_torch`` from DIR (by
default this checkout's ``src/``), builds that tree's kernels into its own
``build/``, and times, by CUDA-graph replay (``chip_smoke.time_graph_ms``,
16 calls a graph, median of 15 replays):

* K6 / K7 at the generate shape: B 4, ring caches of 825, 5 kv heads,
  G 4, rows at qpos 824, 792, 500 and 100;
* K8 / K9 at ``chip_smoke.py``'s mixed case (slots of 854, 500 with a -1
  page, 0 and 100 tokens) and serve shape (4 slots of 760 - 860 tokens).

The inputs come from ``chip_smoke.py``'s case builders of this checkout,
from fixed seeds, so two trees see the same data.  Prints the card's name
and power limit, then one JSON line: the tag, the kernels' ms and each
output's max |out - plain|.  To compare two trees, run it from both in
turns (A, B, B, A) in one call on one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs  # puts this checkout's src/ on the path

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import attention_ops, attention_ref, build

    if not build.CSRC.is_relative_to(Path(args.src).resolve()):
        raise RuntimeError(f"repro_torch came from {build.CSRC}")
    print(cs.smi())
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rq, rk, rv, r8, kpos, rpos = cs._ring_case(gen, 4, 825,
                                                [824, 792, 500, 100])
    paged = {
        "mixed case": cs._paged_case(gen, (854, 500, 0, 100), n_pages=433,
                                     holes=((1, 5),)),
        "serve shape": cs._paged_case(gen, (857, 790, 823, 761)),
    }
    runs = {
        "K6 generate shape": (
            lambda: attention_ops.decode(rq, rk, rv, kpos, rpos),
            attention_ref.decode_attention_ref(rq, rk, rv, kpos, rpos)),
        "K7 generate shape": (
            lambda: attention_ops.decode_q8(rq, *r8, kpos, rpos),
            attention_ref.decode_attention_q8_ref(rq, *r8, kpos, rpos)),
    }
    for label, (qf, k, v, q8, pos, pt, qpos) in paged.items():
        runs[f"K8 {label}"] = (
            lambda qf=qf, k=k, v=v, pos=pos, pt=pt, qpos=qpos:
            attention_ops.decode_paged(qf, k, v, pos, pt, qpos),
            attention_ref.decode_attention_paged_ref(qf, k, v, pos, pt,
                                                     qpos))
        runs[f"K9 {label}"] = (
            lambda qf=qf, q8=q8, pos=pos, pt=pt, qpos=qpos:
            attention_ops.decode_paged_q8(qf, *q8, pos, pt, qpos),
            attention_ref.decode_attention_paged_q8_ref(qf, *q8, pos, pt,
                                                        qpos))
    out = {"tag": args.tag, "ms": {}, "max_abs_err": {}}
    for name, (fn, ref) in runs.items():
        out["max_abs_err"][name] = cs.max_err(fn(), ref)
        out["ms"][name] = cs.time_graph_ms(fn, 16)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
