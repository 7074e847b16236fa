#!/usr/bin/env python3
"""Where the wire kernels spend their time: device time at the wires'
shapes under timing-only edits of the source, for the RD-FSQ wire
(``csrc/rdfsq.cu``: K4 quantize + pack, K5 unpack + dequantize) and the
NF-b wire (``csrc/nf.cu``: K10 quantize + pack, K11 unpack + dequantize).

    python3 scripts/wire_variants.py [--wire rdfsq|nf]

Needs one CUDA device and nvcc; by default it times both wires.

RD-FSQ.  At the serve shape (4 x 933 120 values,
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

NF-b.  At the NF-4 wire's serve shape (4 x 729 x 1280 values, 8 inputs in
rotation for the cold time) and its one-row shape (729 x 1280, 32
inputs), 4 bits, blocks of 64, bf16, it times K10 and K11 the same two
ways on each of their paths (``ops.nf_path`` overridden: ``vector``, and
``scalar``, the first design) under these variants:

* ``built``, ``empty``, ``noload``, ``nostore``, ``b128``: as for RD-FSQ
  (``nostore`` stores under a condition nvcc cannot prove false);
* ``nodiv``: each division becomes a product with a reciprocal (K10's
  by the block's ``rng + 1e-8``, the vector path's three-FMA quotient
  one product; K11's division by 2 a product with 0.5);
* ``noscan``: K10 takes ``norm > 0`` as the code in place of its scan
  over the codebook (scalar) or its bucket lookup (vector); the division
  stays live;
* ``nodivide64``: K11's scalar path finds its block index by a shift in
  place of the 64-bit division (right for the power-of-two words a block
  of these shapes);
* ``exactdiv``: K10's vector path divides every value by ``__fdiv_rn``,
  as its blocks with an out-of-range ``den`` do;
* ``fullgrid``: the vector kernels launch a warp for every warp tile
  in place of striding over one occupancy-sized wave;
* ``noreduce``: K10's vector path at bf16 skips the shuffles that reduce
  a block's min / max over its lane group;
* ``stcs``: K11's vector path stores with the streaming (evict-first)
  cache hint;
* ``lb6`` / ``lb8``: the vector kernels compiled for at least 6 / 8
  blocks of 256 threads an SM (at most 40 / 32 registers a thread).

Its yardstick: ``amax`` over groups of 4 bf16 values (K10's bytes: the
values in, a quarter of their bytes out) and a 4-fold ``expand`` (K11's).

The edited variants compute garbage (their error against the plain
version is printed) and exist only to be timed; each is built from its
wire's source alone into its own library under ``build/wire_variants/``.
One line per run: the variant, the path, then the two kernels' warm and
cold ms at each shape, and max |out - plain| of each.
"""
from __future__ import annotations

import argparse
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
# NF-b: timing-only edits of nf.cu (the vector kernels' and the scalar
# kernels', those of the first design)
NF_EDITS = {
    "built": [],
    "empty": [("  load_book<SB>(book, sbook);\n",
               "  if (n > 0) return;\n  load_book<SB>(book, sbook);\n"),
              ("  constexpr int VEC = 16 / sizeof(T);  // values a chunk\n",
               "  constexpr int VEC = 16 / sizeof(T);  // values a chunk\n"
               "  if (n > 0) return;\n"),
              ("  constexpr int VEC = 16 / sizeof(T);  // outputs a chunk\n",
               "  constexpr int VEC = 16 / sizeof(T);  // outputs a chunk\n"
               "  if (n > 0) return;\n")],
    "noload": [("const float v = idx < n ? load_f32(x + idx) : 0.0f;",
                "const float v = (float)(idx & 63) * 0.01f;"),
               ("const unsigned int word = words[w];",
                "const unsigned int word = (unsigned int)w * 37u;"),
               ("load_chunk<T>(x, idx + 32 * j * VEC, n)",
                "make_uint4(0x3f003e00u + q, 0x3e803f40u + j, 0xbf00be00u,"
                " 0x3c00bc00u + (unsigned int)blk)"),
               ("d.bits[j][0] = reinterpret_cast<const unsigned int*>(wrow)"
                "[c];", "d.bits[j][0] = (unsigned int)c * 2654435761u;")],
    "nostore": [("    words[blk * nbytes + j] = (uint8_t)word;",
                 "    if (word == (unsigned int)n * 2654435761u)"
                 " words[blk * nbytes + j] = (uint8_t)word;"),
                ("    store_f32(out + idx, val);",
                 "    if (val == -12345.0f) store_f32(out + idx, val);"),
                ("          reinterpret_cast<unsigned int*>(wrow)[c] = "
                 "bits[0];\n",
                 "        { if (bits[0] == (unsigned int)n * 2654435761u)"
                 " reinterpret_cast<unsigned int*>(wrow)[c] = bits[0]; }\n"),
                ("        store16(out + at, o);",
                 "        if (o[0] == (unsigned int)n * 2654435761u)"
                 " store16(out + at, o);")],
    "nodiv": [("  const float den = __fadd_rn(rng, 1e-8f);\n",
               "  const float den = __fadd_rn(rng, 1e-8f);\n"
               "  const float rden = 1.0f / den;\n"),
              ("__fdiv_rn(__fmul_rn(2.0f, __fsub_rn(v, lo)), den)",
               "__fmul_rn(__fmul_rn(2.0f, __fsub_rn(v, lo)), rden)"),
              ("code = nf_code<SB>(div_fast(d, half_den, y), dt);",
               "code = nf_code<SB>(__fmul_rn(d, y), dt);"),
              ("__fdiv_rn(__fadd_rn(norm, 1.0f), 2.0f)",
               "__fmul_rn(__fadd_rn(norm, 1.0f), 0.5f)")],
    "noscan": [("      int best = 0;\n", "      int best = norm > 0.0f;\n"),
               ("for (int c = 1; c < LEVELS; ++c) {",
                "for (int c = 1; c < 1; ++c) {"),
               ("code = nf_code<SB>(div_fast(d, half_den, y), dt);",
                "code = div_fast(d, half_den, y) > 1.0f;")],
    "nodivide64": [("const int64_t blk = w / (G / PER);",
                    "const int64_t blk = w >> (__ffs(G / PER) - 1);")],
    "b128": [("constexpr int kThreads = 256;",
              "constexpr int kThreads = 128;")],
    "exactdiv": [("const bool fast = __all_sync(kFull, den < 0x1p125f);",
                  "const bool fast = __all_sync(kFull, den < 0.0f);")],
    "fullgrid": [("return (unsigned int)(blocks < wave ? blocks : wave);",
                  "return (unsigned int)blocks;")],
    "noreduce": [("        if (off < P)  // P is the warp's",
                  "        if (off < 0)  // P is the warp's")],
    "stcs": [("st.global.v4.u32", "st.global.cs.v4.u32")],
    "lb6": [("__launch_bounds__(kThreads)\n    nf_quantize_vector(",
             "__launch_bounds__(kThreads, 6)\n    nf_quantize_vector("),
            ("__launch_bounds__(kThreads)\n    nf_dequantize_vector(",
             "__launch_bounds__(kThreads, 6)\n    nf_dequantize_vector(")],
    "lb8": [("__launch_bounds__(kThreads)\n    nf_quantize_vector(",
             "__launch_bounds__(kThreads, 8)\n    nf_quantize_vector("),
            ("__launch_bounds__(kThreads)\n    nf_dequantize_vector(",
             "__launch_bounds__(kThreads, 8)\n    nf_dequantize_vector(")],
}
NF_FNS = ("nf_quantize", "nf_dequantize")
# (values, inputs in rotation for the cold time)
NF_SHAPES = {"serve": (4 * 729 * 1280, 8), "one-row": (729 * 1280, 32)}
NF_BITS, NF_BLOCK = 4, 64
ORDER = list(EDITS)
FNS = ("rdfsq_quantize", "rdfsq_dequantize")
SHAPES = {"serve": (4, 729 * 1280), "group": (4, 729 * 160)}
BITS, COLD, CALLS = 2, 8, 32
PATHS = ("vector", "scalar")


def _variant_libs(build, source: str, edits: dict, fns) -> dict:
    """Build every variant from ``source`` (a file of ``csrc/``), one nvcc
    each, all started together."""
    out = ROOT / "build" / "wire_variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    procs = {}
    for name, subs in edits.items():
        src = (build.CSRC / source).read_text()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {source}")
            src = src.replace(old, new)
        cu, so = out / f"{stem}_{name}.cu", out / f"lib_{stem}_{name}.so"
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
        for fn in fns:
            getattr(lib, fn).argtypes = build._ARGTYPES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _cases(gen):
    """RD-FSQ, per shape: COLD tuples of (x, stats) for K4 and of (words,
    stats16) for K5, the words made by the plain version."""
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
            cols.append(_time(cs, fn, args, label, tag, eager))
    return ", ".join(cols) + " ms; errors " + ", ".join(errs)


def _time(cs, fn, args, label, tag, eager: bool) -> str:
    """Warm and cold (and eager) ms of ``fn``: one input, then the inputs
    of ``args`` in rotation, ``CALLS`` calls a graph."""
    warm = cs.time_graph_ms(lambda: fn(*args[0]), CALLS)
    cold = cs.time_graph_cold_ms(fn, args * (CALLS // len(args)))
    col = f"{tag} {label} warm {warm:.5f} cold {cold:.5f}"
    if eager:
        col += f" eager {cs.time_ms(lambda: fn(*args[0])):.5f}"
    return col


def _rdfsq(cs, build, ops, gen) -> None:
    import torch

    libs = _variant_libs(build, "rdfsq.cu", EDITS, FNS)
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

        cols += [_time(cs, reads, k4, label, "amax over 8", False),
                 _time(cs, writes, outs, label, "expand x 8", False)]
    print("yardstick " + ", ".join(cols) + " ms", flush=True)


def _run_nf(cs, ops, cases, refs, book, eager: bool) -> str:
    """K10 / K11 warm and cold (and eager) ms at each shape, and the
    errors."""
    import torch

    cols, errs = [], []
    for label, (n, k10, k11) in cases.items():
        def q(x):
            return ops.nf_quantize_kernel(x, book, NF_BITS, NF_BLOCK)

        def d(words, m, rng, n=n):
            return ops.nf_dequantize_kernel(words, m, rng, book, NF_BITS,
                                            NF_BLOCK, n, torch.bfloat16)

        errs += [f"K10 {label} "
                 f"{cs.max_err(q(*k10[0])[0], refs[label][0]):.1e}",
                 f"K11 {label} {cs.max_err(d(*k11[0]), refs[label][1]):.1e}"]
        cols += [_time(cs, q, k10, label, "K10", eager),
                 _time(cs, d, k11, label, "K11", eager)]
    return ", ".join(cols) + " ms; errors " + ", ".join(errs)


def _nf(cs, build, ops, gen) -> None:
    import torch
    from repro_torch.core.quantizers.nf import codebook_tensor
    from wire_ab import nf_inputs

    libs = _variant_libs(build, "nf.cu", NF_EDITS, NF_FNS)
    book = codebook_tensor(NF_BITS, torch.device("cuda"))
    cases = {label: (n, *nf_inputs(gen, n, count, NF_BITS))
             for label, (n, count) in NF_SHAPES.items()}
    for label, (n, k10, k11) in cases.items():
        n_bytes = cs._nbytes(k10[0][0], *k11[0], book)
        print(f"bound NF {label} {n} values: {n_bytes} B, "
              f"{cs.bound(n_bytes)[0]:.5f} ms (bytes) each of K10, K11")
    refs = {label: (k11[0][0], ops.nf_dequantize_plain(
        *k11[0], book, NF_BITS, NF_BLOCK, n, torch.bfloat16))
        for label, (n, k10, k11) in cases.items()}
    order = list(NF_EDITS)
    chosen = ops.nf_path
    try:
        for name in order + order[::-1]:
            build._lib = libs[name]
            for path in PATHS:
                ops.nf_path = lambda *args, path=path: path
                print(f"{name:10s} {path:6s} "
                      + _run_nf(cs, ops, cases, refs, book, name == "built"),
                      flush=True)
    finally:
        ops.nf_path = chosen
    cols = []
    for label, (n, k10, k11) in cases.items():
        small = k10[0][0][:n // 4].contiguous()
        outs = [(torch.empty_like(x),) for x, in k10]

        def reads(x, n=n):  # K10's bytes: n values in, a quarter out
            return x.view(n // 4, 4).amax(-1)

        def writes(out, n=n, small=small):  # K11's: a quarter in, n out
            return out.view(n // 4, 4).copy_(
                small[:, None].expand(n // 4, 4))

        cols += [_time(cs, reads, k10, label, "amax over 4", False),
                 _time(cs, writes, outs, label, "expand x 4", False)]
    print("yardstick NF " + ", ".join(cols) + " ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wire", choices=("rdfsq", "nf"), action="append",
                    help="the wire whose kernels to time (default: both)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wire_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    print(cs.smi())
    gen = torch.Generator(device="cuda").manual_seed(1234)
    wires = args.wire or ["rdfsq", "nf"]
    if "rdfsq" in wires:
        _rdfsq(cs, build, ops, gen)
    if "nf" in wires:
        _nf(cs, build, ops, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
