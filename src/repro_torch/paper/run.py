"""Run the paper's experiments on the port (the twin of
``benchmarks/run.py``'s paper suites).

    PYTHONPATH=src python -m repro_torch.paper.run [--only table1,table2,...]
        [--full] [--fast] [--device cpu] [--out PATH]

Prints ``name,us_per_call,derived`` rows under the reference's names.
``--full`` runs tinyllava at its full width (16 layers, d 1 280, 729
image tokens) in place of ``reduced()``; ``--fast`` takes the reference's
smaller training budgets (Table 3: 30 steps); ``--out`` writes every
suite's result as one JSON document (nothing is written without it).
A suite that fails prints its traceback, and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.paper import (quant_curve, table1_entropy, table2_bits,
                               table3_performance, table4_comm)
from repro_torch.paper.common import emit


def _roofline(cfg, args):
    """The weight-bytes rows of ``benchmarks/roofline.py`` (the dry-run
    half of that suite is XLA-only)."""
    table = roofline.weight_bytes_rows()
    for arch, row in table.items():
        dense = row["bf16"]
        emit(f"roofline/weight_bytes/{arch}", dense / 2 ** 20,
             f"bf16_MiB={dense / 2**20:.1f};"
             f"int4_MiB={row['int4'] / 2**20:.1f};"
             f"int4_cut={row['int4_ratio']:.2f}x;"
             f"int3_MiB={row['int3'] / 2**20:.1f};"
             f"int3_cut={row['int3_ratio']:.2f}x;group=128")
    return table


def _jsonable(obj):
    """Tuple keys as 'a_b' strings; payloads (Table 2) left out."""
    if isinstance(obj, dict):
        return {("_".join(map(str, k)) if isinstance(k, tuple) else str(k)):
                _jsonable(v) for k, v in obj.items() if k != "payload"}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


SUITES = {
    "table1": lambda cfg, a: table1_entropy.run(cfg=cfg, device=a.device),
    "table2": lambda cfg, a: table2_bits.run(device=a.device),
    "table3": lambda cfg, a: table3_performance.run(
        n_steps=30 if a.fast else 120, cfg=cfg, device=a.device),
    "table4": lambda cfg, a: table4_comm.run(cfg=cfg, device=a.device),
    "curve": lambda cfg, a: quant_curve.run(
        cfg=cfg, n_eval=8 if a.fast else 16, device=a.device),
    "roofline": _roofline,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(SUITES))
    ap.add_argument("--full", action="store_true",
                    help="full-width tinyllava in place of reduced()")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's smaller training budgets")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path (default: CUDA)")
    ap.add_argument("--out", default=None,
                    help="write the results as JSON to this path")
    args = ap.parse_args(argv)
    names = list(SUITES) if not args.only else args.only.split(",")
    unknown = [n for n in names if n not in SUITES]
    if unknown:
        ap.error(f"unknown suites {unknown}; known: {list(SUITES)}")
    cfg = get_config("tinyllava")
    cfg = cfg if args.full else cfg.reduced()
    print("name,us_per_call,derived")
    results, failures = {}, []
    for name in names:
        try:
            results[name] = SUITES[name](cfg, args)
        except Exception:  # noqa: BLE001  a suite's failure is reported
            failures.append(name)
            traceback.print_exc()
    if args.out:
        Path(args.out).write_text(json.dumps(_jsonable(results), indent=1)
                                  + "\n")
        print(f"wrote {args.out}")
    if failures:
        print(f"paper suites failed: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
