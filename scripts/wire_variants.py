#!/usr/bin/env python3
"""Where the RD-FSQ wire kernels (``csrc/rdfsq.cu``: K4 quantize + pack,
K5 unpack + dequantize) spend their time: device time at the wire's two
shapes under timing-only edits of the source.

    python3 scripts/wire_variants.py

Needs one CUDA device and nvcc.  At the serve shape (4 x 933 120 values,
729 image tokens x 1280 channels) and at the adaptive wire's group shape
(4 x 116 640: 729 x 160), 2 bits, bf16, it times K4 and K5 on each of
their two paths (``ops.rdfsq_path`` overridden: ``vector``, and
``scalar``, the design before the vector path) by CUDA-graph replay of 32
calls, two ways (``chip_smoke.time_graph_ms`` / ``time_graph_cold_ms``):

* warm: one input, so the bytes stay in the 50 MB L2, as on the serve
  path where the connector has just written ``x``;
* cold: 8 inputs in rotation, every call's output a buffer of its own
  (at the serve shape 60 MB of inputs: past the L2).

Variants, each in the order given, then in reverse, so that drift shows:

* ``built``: the kernels as built (also timed eager, ``chip_smoke.time_ms``);
* ``empty``: every thread returns at once: the launch alone;
* ``noload``: K4 reads no ``x``, K5 no words (made-up values instead);
* ``nostore``: the outputs are computed but stored only under a condition
  that never holds;
* ``nodiv``: divisions by a per-row or per-width constant become products
  with its reciprocal;
* ``nosearch``: K4's vector path takes evenly spaced thresholds in place
  of its 32-way search: the search's cost;
* ``wide``: the vector path with two 8-byte groups of words a thread;
* ``direct``: K4's vector path with the op sequence per element at every
  width, no thresholds;
* ``b128``: blocks of at most 128 threads (of data threads on the vector
  path), twice as many blocks;
* ``pf256`` / ``noalloc``: the vector path's 16-byte loads with an L2
  prefetch-size hint of 256 B, or without allocating in L1;
* ``tma``: K4's vector path at 2 bits in bf16 fetches a run's values with
  one TMA bulk copy into shared memory and reads its chunks from there;
* ``nocompute``: K4's vector path at bf16 folds each chunk's loaded words
  into its code bits without comparing: the loads, staging and stores
  alone.

Then a yardstick line: PyTorch's own kernels moving the same bytes, timed
the same two ways: ``amax`` over groups of 8 values (K4's bytes: the
values in, 1/8 of them out) and an 8-fold ``expand`` copied into the
output (K5's: 1/8 in, the values out).

The edited variants compute garbage (their error against the plain
version is printed) and exist only to be timed; each is built from
``rdfsq.cu`` alone into its own library under ``build/wire_variants/``.
One line per run: the variant, the path, then K4 / K5 warm and cold ms at
each shape, and max |out - plain| of each.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# source edits of the timing-only variants: (old, new) replacements, each
# applied to every occurrence (the scalar kernels' first, then the vector
# kernels')
EDITS = {
    "built": [],
    "empty": [("  const int64_t row = blockIdx.y;\n",
               "  if (C > 0) return;\n  const int64_t row = blockIdx.y;\n"),
              ("  const int64_t gpr = CW / 8;\n",
               "  if (C > 0) return;\n  const int64_t gpr = CW / 8;\n")],
    "noload": [("const float v = col < C ? load_f32(xr + col) : 0.0f;",
                "const float v = (float)(col & 7) * 0.1f;"),
               ("const unsigned int word = words[row * CW + w];",
                "const unsigned int word = (unsigned int)w * 37u;"),
               ("v[g][j] = load16(xr + col);",
                "v[g][j] = make_uint4((unsigned)col, j, 7u, lane);"),
               ("w[g] = gi < gpr ? load8(words + row * CW + 8 * gi)",
                "w[g] = gi < gpr ? make_uint2((unsigned)gi * 2654435761u, lane)")],
    "nostore": [("  words[row * CW + w] = (uint8_t)word;",
                 "  if (word == 0xDEADu) words[row * CW + w] = (uint8_t)word;"),
                ("    store_f32(orow + col, val);",
                 "    if (val == -12345.0f) store_f32(orow + col, val);"),
                ("        if (gi < gpr)\n          reinterpret_cast<uint2*>(words",
                 "        if (gi < 0)\n          reinterpret_cast<uint2*>(words"),
                ("          store16(orow + col, o);",
                 "          if (o[0] == 0xDEADBEEFu) store16(orow + col, o);")],
    "nodiv": [("const float den = __fadd_rn(__fsub_rn(hi, lo), 1e-6f);",
               "const float den = __fadd_rn(__fsub_rn(hi, lo), 1e-6f);"
               " const float rden = 1.0f / den;"),
              ("__fdiv_rn(__fmul_rn(2.0f, __fsub_rn(xc, lo)), den)",
               "__fmul_rn(__fmul_rn(2.0f, __fsub_rn(xc, lo)), rden)"),
              ("__fdiv_rn(__fsub_rn(code, half), half)",
               "__fmul_rn(__fsub_rn(code, half), 1.0f / half)"),
              ("__fdiv_rn(__fadd_rn(c, 1.0f), 2.0f)",
               "__fmul_rn(__fadd_rn(c, 1.0f), 0.5f)"),
              ("__fdiv_rn(__fmul_rn(2.0f, __fsub_rn(c, lo)), den)",
               "__fmul_rn(__fmul_rn(2.0f, __fsub_rn(c, lo)), __frcp_rn(den))")],
    "nosearch": [("const float t = code_threshold(k + 1, lo, hi, den, half,"
                  " lane);",
                  "const float t = __fadd_rn(lo, __fmul_rn((k + 1.0f) /"
                  " (NTHR + 1.0f), __fsub_rn(hi, lo)));")],
    "wide": [("constexpr int kGroups = 1;", "constexpr int kGroups = 2;")],
    "direct": [("return SB <= 2 ? (1 << SB) - 1 : 0;", "return 0;")],
    "b128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "pf256": [("ld.global.nc.v4.u32", "ld.global.nc.L2::256B.v4.u32")],
    "noalloc": [("ld.global.nc.v4.u32",
                 "ld.global.nc.L1::no_allocate.v4.u32")],
    "tma": [  # K4 at 2 bits in bf16: the run's values by one bulk copy
        ("  constexpr int NTHR = quantize_prologue_warps<SB>();  // thresholds\n",
         "  constexpr int NTHR = quantize_prologue_warps<SB>();  // thresholds\n"
         "  constexpr bool kTma = sizeof(T) == 2 && SB == 2;\n"
         "  constexpr int kTileBytes =\n"
         "      kTma ? kThreads * kGroups * CODES * (int)sizeof(T) : 16;\n"
         "  __shared__ __align__(128) uint8_t tile_in[kTileBytes];\n"
         "  __shared__ __align__(8) uint64_t loaded;\n"),
        ("    if (threadIdx.x == 0) hopper::mbar_init(&published, 32 * NTHR);\n"
         "    __syncthreads();\n  }\n",
         "    if (threadIdx.x == 0) hopper::mbar_init(&published, 32 * NTHR);\n"
         "    __syncthreads();\n  }\n"
         "  if constexpr (kTma) {\n    if (threadIdx.x == 0) {\n"
         "      hopper::mbar_init(&loaded, 1);\n"
         "      hopper::fence_barrier_init();\n    }\n    __syncthreads();\n  }\n"
         "  uint32_t ld_phase = 0;\n"),
        ("      uint4 v[kGroups][LOADS];\n",
         "      uint4 v[kGroups][LOADS];\n"
         "      const int64_t col0 =\n"
         "          (tile % tiles_per_row) * nthreads * kGroups * CODES;\n"
         "      int64_t tile_bytes = 0;\n"
         "      if constexpr (kTma) {\n"
         "        const int64_t avail = (C - col0) * (int64_t)sizeof(T);\n"
         "        const int64_t full = (int64_t)nthreads * kGroups * CODES * 2;\n"
         "        tile_bytes = (full < avail ? full : avail) & ~(int64_t)15;\n"
         "        if (threadIdx.x == 0) {\n"
         "          hopper::mbar_expect_tx(&loaded, (uint32_t)tile_bytes);\n"
         "          asm volatile(\"cp.async.bulk.shared::cluster.global.mbarrier\"\n"
         "                       \"::complete_tx::bytes [%0], [%1], %2, [%3];\"\n"
         "                       ::\"r\"(hopper::smem_u32(tile_in)), \"l\"(xr + col0),\n"
         "                       \"r\"((uint32_t)tile_bytes),\n"
         "                       \"r\"(hopper::smem_u32(&loaded)) : \"memory\");\n"
         "        }\n"
         "        hopper::mbar_wait(&loaded, ld_phase);\n"
         "        ld_phase ^= 1u;\n"
         "      }\n"),
        ("          if (col + VEC <= C) {\n            v[g][j] = load16(xr + col);\n",
         "          if (kTma && (col - col0) * 2 + 16 <= tile_bytes) {\n"
         "            v[g][j] = *reinterpret_cast<const uint4*>(\n"
         "                tile_in + (col - col0) * sizeof(T));\n"
         "          } else if (col + VEC <= C) {\n"
         "            v[g][j] = load16(xr + col);\n")],
    "nocompute": [("bits[0] = bf16_chunk_codes<SB>(v[g][j], T1, T2, T3);",
                   "bits[0] = v[g][j].x ^ v[g][j].y ^ v[g][j].z ^ v[g][j].w"
                   " ^ T1;")],
}
ORDER = list(EDITS)
FNS = ("rdfsq_quantize", "rdfsq_dequantize")
SHAPES = {"serve": (4, 729 * 1280), "group": (4, 729 * 160)}
BITS, COLD, CALLS = 2, 8, 32
PATHS = ("vector", "scalar")


def _variant_libs(build) -> dict:
    """Build every variant from ``rdfsq.cu``, one nvcc each, all started
    together."""
    out = ROOT / "build" / "wire_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        src = (build.CSRC / "rdfsq.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in rdfsq.cu")
            src = src.replace(old, new)
        cu, so = out / f"rdfsq_{name}.cu", out / f"lib_{name}.so"
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
        if name == "built":
            print("\n".join(line for line in log.splitlines()
                            if "registers" in line or "spill" in line))
        lib = ctypes.CDLL(str(so))
        for fn in FNS:
            getattr(lib, fn).argtypes = build._ARGTYPES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _cases(gen):
    """Per shape: COLD tuples of (x, stats) for K4 and of (words, stats16)
    for K5, the words made by the plain version."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rdfsq_stats

    cases = {}
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
        cases[label] = (c, k4, k5)
    return cases


def _run(cs, cases, refs, eager: bool) -> str:
    """K4 / K5 warm and cold (and eager) ms at each shape, and the errors."""
    import torch
    from repro_torch.kernels import ops

    cols, errs = [], []
    for label, (c, k4, k5) in cases.items():
        def q(x, stats):
            return ops.quantize_kernel(x, stats, BITS)

        def d(words, st16, c=c):
            return ops.dequantize_kernel(words, st16, BITS, c,
                                         torch.bfloat16)

        for tag, fn, args, ref in (("K4", q, k4, refs[label][0]),
                                   ("K5", d, k5, refs[label][1])):
            errs.append(f"{tag} {label} {cs.max_err(fn(*args[0]), ref):.1e}")
            warm = cs.time_graph_ms(lambda: fn(*args[0]), CALLS)
            cold = cs.time_graph_cold_ms(fn, args * (CALLS // COLD))
            col = f"{tag} {label} warm {warm:.5f} cold {cold:.5f}"
            if eager:
                col += f" eager {cs.time_ms(lambda: fn(*args[0])):.5f}"
            cols.append(col)
    return ", ".join(cols) + " ms; errors " + ", ".join(errs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wire_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    print(cs.smi())
    libs = _variant_libs(build)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = _cases(gen)
    for label, (r, c) in SHAPES.items():
        n_bytes = r * c * (2 + BITS / 8) + r * 2 * 4
        print(f"bound {label} {r} x {c}: {n_bytes:.0f} B, "
              f"{cs.bound(n_bytes)[0]:.5f} ms (bytes) each of K4, K5")
    refs = {label: (ops.quantize_plain(*k4[0], BITS),
                    ops.dequantize_plain(*k5[0], BITS, c, torch.bfloat16))
            for label, (c, k4, k5) in cases.items()}
    chosen = ops.rdfsq_path
    try:
        for name in ORDER + ORDER[::-1]:
            build._lib = libs[name]
            for path in PATHS:
                ops.rdfsq_path = lambda *args, path=path: path
                print(f"{name:8s} {path:6s} " + _run(cs, cases, refs,
                                                     eager=name == "built"),
                      flush=True)
    finally:
        ops.rdfsq_path = chosen
    cols = []
    for label, (c, k4, k5) in cases.items():
        r = SHAPES[label][0]
        small = k4[0][0][:, :c // 8].contiguous()
        outs = [(torch.empty_like(x),) for x, _ in k4]

        def reads(x, stats, r=r, c=c):  # K4's bytes: c values in, c / 8 out
            return x.view(r, c // 8, 8).amax(-1)

        def writes(out, r=r, c=c, small=small):  # K5's: c / 8 in, c out
            return out.view(r, c // 8, 8).copy_(
                small[..., None].expand(r, c // 8, 8))

        for tag, fn, args in (("amax over 8", reads, k4),
                              ("expand x 8", writes, outs)):
            warm = cs.time_graph_ms(lambda: fn(*args[0]), CALLS)
            cold = cs.time_graph_cold_ms(fn, args * (CALLS // COLD))
            cols.append(f"{tag} {label} warm {warm:.5f} cold {cold:.5f}")
    print("yardstick " + ", ".join(cols) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
