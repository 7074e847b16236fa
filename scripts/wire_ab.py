#!/usr/bin/env python3
"""Device time of the wire kernels of one checkout, for comparing two
checkouts on one card: RD-FSQ K4 (quantize + pack) / K5 (unpack +
dequantize) and NF-b K10 (quantize + pack) / K11 (unpack + dequantize).

    python3 scripts/wire_ab.py [--src DIR] [--tag NAME] [--wire rdfsq|nf]

Needs one CUDA device and nvcc.  Imports ``repro_torch`` from DIR (by
default this checkout's ``src/``), builds that tree's kernels into its own
``build/``, and times, by CUDA-graph replay of 32 calls (median of 15
replays), two ways: warm (one input, L2-resident;
``chip_smoke.time_graph_ms``) and cold (inputs in rotation, every output a
buffer of its own, together past the 50 MB L2;
``chip_smoke.time_graph_cold_ms``):

* K4 and K5 at 2 bits in bf16 at the serve shape (4 x 933 120 values: 729
  image tokens x 1280 channels) and at the adaptive wire's group shape (4
  x 116 640: 729 x 160), 8 inputs in rotation;
* K10 and K11 at 4 bits, blocks of 64, in bf16, at the NF-4 wire's serve
  shape (4 x 729 x 1280 values: 8 inputs in rotation) and at its one-row
  shape (729 x 1280, the smoke's one-row prefill batches: 32 inputs), and
  at 8 bits at the serve shape.

NF-b also runs the edge blocks of ``chip_smoke.nf_edge_blocks`` (a NaN,
+inf, -inf, range 0, an outlier and ``linspace(-1e38, 2e38, 64)``, whose
``2 (x - m)`` overflows) at 1, 2, 4 and 8 bits in bf16 and fp32 through
K10 and K11 and says whether words, m, rng (NaN in the same places) and
K11's output equal the plain versions'.

The inputs come from fixed seeds, so two trees see the same data.  Prints
the card's name and power limit, then one JSON line: the tag, the
kernels' ms, each output's max |out - plain| and the NF edge checks.  To
compare two trees, run it from both in turns (A, B, B, A) in one call on
one card.
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
# NF-b: (values, inputs in rotation for the cold time, bits)
NF_SHAPES = {"serve shape": (4 * 729 * 1280, 8, 4),
             "one-row shape": (729 * 1280, 32, 4),
             "serve shape 8 bits": (4 * 729 * 1280, 8, 8)}
NF_BLOCK = 64


def _rdfsq(cs, gen, out) -> None:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rdfsq_stats

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


def nf_inputs(gen, n: int, count: int, bits: int):
    """``count`` tuples (x,) of n bf16 values and their K11 operands
    (words, m, rng) from the plain K10."""
    import torch
    from repro_torch.core.quantizers.nf import codebook_tensor
    from repro_torch.kernels import ops

    book = codebook_tensor(bits, torch.device("cuda"))
    k10, k11 = [], []
    for _ in range(count):
        x = (torch.randn((n,), generator=gen, device="cuda") * 0.7
             + 0.1).bfloat16()
        x[:3] = 25.0
        k10.append((x,))
        k11.append(ops.nf_quantize_plain(x, book, bits, NF_BLOCK))
    return k10, k11


def nf_edges(cs, bits: int, dtype) -> dict:
    """K10 / K11 against their plain versions on the edge blocks of
    ``chip_smoke.nf_edge_blocks``."""
    import torch
    from repro_torch.core.quantizers.nf import codebook_tensor
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((6 * NF_BLOCK,), generator=gen, device="cuda") * 0.7
         + 0.1).to(dtype)
    cs.nf_edge_blocks(x, NF_BLOCK)
    book = codebook_tensor(bits, x.device)
    words, m, rng = ops.nf_quantize_kernel(x, book, bits, NF_BLOCK)
    rw, rm, rr = ops.nf_quantize_plain(x, book, bits, NF_BLOCK)
    y = ops.nf_dequantize_kernel(rw, rm, rr, book, bits, NF_BLOCK,
                                 x.numel(), dtype)
    ry = ops.nf_dequantize_plain(rw, rm, rr, book, bits, NF_BLOCK,
                                 x.numel(), dtype)
    torch.cuda.synchronize()
    return dict(words=bool(torch.equal(words, rw)), m=cs.same_nan(m, rm),
                rng=cs.same_nan(rng, rr), out=cs.same_nan(y, ry),
                nan_block_m=float(m[0, 0]),
                nan_block_words_zero=bool((words[0] == 0).all()))


def _nf(cs, gen, out) -> None:
    import torch
    from repro_torch.core.quantizers.nf import codebook_tensor
    from repro_torch.kernels import ops

    for label, (n, count, bits) in NF_SHAPES.items():
        k10, k11 = nf_inputs(gen, n, count, bits)
        book = codebook_tensor(bits, torch.device("cuda"))

        def q(x, book=book, bits=bits):
            return ops.nf_quantize_kernel(x, book, bits, NF_BLOCK)

        def d(words, m, rng, n=n, book=book, bits=bits):
            return ops.nf_dequantize_kernel(words, m, rng, book, bits,
                                            NF_BLOCK, n, torch.bfloat16)

        ref_y = ops.nf_dequantize_plain(*k11[0], book, bits, NF_BLOCK, n,
                                        torch.bfloat16)
        out["max_abs_err"][f"K10 {label}"] = cs.max_err(q(*k10[0])[0],
                                                        k11[0][0])
        out["max_abs_err"][f"K11 {label}"] = cs.max_err(d(*k11[0]), ref_y)
        for tag, fn, inputs in (("K10", q, k10), ("K11", d, k11)):
            out["ms"][f"{tag} {label} warm"] = cs.time_graph_ms(
                lambda: fn(*inputs[0]), CALLS)
            out["ms"][f"{tag} {label} cold"] = cs.time_graph_cold_ms(
                fn, inputs * (CALLS // count))
    out["nf_edges"] = {f"{b} bits {str(dt)[6:]}": nf_edges(cs, b, dt)
                       for b in (1, 2, 4, 8)
                       for dt in (torch.bfloat16, torch.float32)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--wire", choices=("rdfsq", "nf"), action="append",
                    help="the wire kernels to time (default: both)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wire_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs  # puts this checkout's src/ on the path

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build

    if not build.CSRC.is_relative_to(Path(args.src).resolve()):
        raise RuntimeError(f"repro_torch came from {build.CSRC}")
    print(cs.smi())
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = {"tag": args.tag, "ms": {}, "max_abs_err": {}}
    wires = args.wire or ["rdfsq", "nf"]
    if "rdfsq" in wires:
        _rdfsq(cs, gen, out)
    if "nf" in wires:
        _nf(cs, gen, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
