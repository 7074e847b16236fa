#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. build   -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
              (first use), print the build time and the card.
2. kernels -- hold K1 (flash forward), K2 / K3 (flash backward), K4 / K5
              (RD-FSQ wire) and K8 (paged decode) against their plain
              PyTorch versions on the card, at the main paths' shapes plus
              edge cases; time each (CUDA events, median), its plain
              version and, where one PyTorch call computes the same
              function, that call.
3. serve   -- full-width tinyllava (16 layers, d 1280, bf16, random weights
              from a seed) behind ServeEngine with the 2-bit RD-FSQ split
              wire: 8 requests through 4 slots until all finish.  Launch
              counts are zeroed right before and read right after.
4. parity  -- one request's prefill logits on the card against the port's
              own CPU path in fp32 from the same weights.
5. train   -- the paper's training step on the same model: 30 steps of
              make_train_step (composite loss through the 2-bit RD-FSQ
              compressor, remat, warmup-cosine AdamW) on batches of 4 x 793
              positions from the port's data pipeline.  Launch counts are
              zeroed right before and read right after.
6. train parity -- one step's loss, gradient norm and per-leaf gradient
              cosine on the card against the port's fp32 CPU path.

The last lines are the card (nvidia-smi), the per-kernel JSON line and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
SRC = "src/repro_torch/kernels/csrc/"
REPLACES = {
    "flash_fwd": "src/repro/kernels/flash_kernel.py:109",
    "flash_bwd_dq": "src/repro/kernels/flash_kernel.py:189",
    "flash_bwd_dkv": "src/repro/kernels/flash_kernel.py:266",
    "rdfsq_quantize": "src/repro/kernels/rdfsq_kernel.py:74",
    "rdfsq_dequantize": "src/repro/kernels/rdfsq_kernel.py:93",
    "decode_paged": "src/repro/kernels/decode_kernel.py:262",
}
SOURCES = {"flash_fwd": SRC + "flash_fwd.cu",
           "flash_bwd_dq": SRC + "flash_bwd.cu",
           "flash_bwd_dkv": SRC + "flash_bwd.cu",
           "rdfsq_quantize": SRC + "rdfsq.cu",
           "rdfsq_dequantize": SRC + "rdfsq.cu",
           "decode_paged": SRC + "decode_paged.cu"}

# tolerances of kernel vs plain version, bf16 operands on the card
FLASH_OUT_ATOL = 2e-2   # P is rounded to bf16 at different running maxima
STATS_ATOL = 1e-3       # m: fp32 sums of exact bf16 products, other order
L_RTOL = 1e-3           # l: fp32 sums of exp, other order and rescaling
DECODE_ATOL = 2e-2      # as FLASH_OUT_ATOL, over one slot's pages
# dq / dk / dv against the plain version, relative to max |plain|: P and dS
# are rounded to bf16 from fp32 values summed in another order
FLASH_BWD_RTOL = 2e-2
PARITY_RTOL = 5e-2      # bf16 card path vs fp32 CPU path, 16 layers
# one training step, bf16 card path vs fp32 CPU path: bf16 through 16
# layers and 2-bit codes flipped by it move the forward by about 1e-2
TRAIN_LOSS_RTOL = 5e-2
GRAD_COS_MIN = 0.98
TRAIN_STEPS, TRAIN_BATCH, TRAIN_TEXT = 30, 4, 64


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def time_ms(fn, reps: int = 15, inner: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(n_bytes: float, flops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def require(ok: bool, what) -> None:
    """A phase's check; unlike ``assert`` it holds under ``python -O``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s: {path.relative_to(ROOT)}")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[build] {line.strip()}")
    print(f"[build] card: {smi()}")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def _flash_case(gen, b, sq, h, kh, window=None, kv_valid_len=None,
                chunk=512):
    """Operands as ``flash_attention`` builds them: (B, S, H, D) tensors,
    q pre-scaled then padded to the chunk, sentinel positions."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention_ref import FAR

    dev, d = "cuda", 64
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, sq, kh, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, sq, kh, d), generator=gen, device=dev).bfloat16()
    c = min(chunk, sq)
    pad = (-sq) % c
    qs = F.pad(q * torch.tensor(d ** -0.5, dtype=q.dtype),
               (0, 0, 0, 0, 0, pad))
    k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    pos = torch.arange(sq, dtype=torch.int32, device=dev)
    qpos = F.pad(pos, (0, pad), value=-FAR)
    kpos = torch.full((sq + pad,), FAR, dtype=torch.int32, device=dev)
    kpos[:sq] = pos
    if kv_valid_len is not None:
        kpos[kv_valid_len:] = FAR
    return (qs.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            qpos, kpos, window)


def check_flash(gen, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention_ops, attention_ref

    cases = {
        "serve shape B4 S1024": _flash_case(gen, 4, 1024, 20, 5),
        "padded q tail S777 + kv_valid_len 700":
            _flash_case(gen, 2, 777, 20, 5, kv_valid_len=700),
        "window 256": _flash_case(gen, 1, 1024, 20, 5, window=256),
        "ragged tiles S100": _flash_case(gen, 1, 100, 20, 5),
    }
    worst = 0.0
    for name, (q, k, v, qpos, kpos, window) in cases.items():
        out, m, l = attention_ops.flash_forward(q, k, v, qpos, kpos,
                                                window=window)
        ro, rm, rl = attention_ref.flash_forward_ref(q, k, v, qpos, kpos,
                                                     window=window)
        torch.cuda.synchronize()
        e_out, e_m = max_err(out, ro), max_err(m, rm)
        e_l = float(((l - rl).abs() / rl.abs().clamp_min(1e-30)).max())
        dead = (rl == 0).reshape(-1)  # rows with no visible key
        exact0 = bool((out.reshape(-1, out.shape[-1])[dead] == 0).all())
        print(f"[kernels] K1 flash_fwd {name}: max|out-plain| {e_out:.3e} "
              f"(tol {FLASH_OUT_ATOL}), max|m-plain| {e_m:.3e}, "
              f"max rel l {e_l:.3e}, masked rows exact 0: {exact0}")
        require(e_out <= FLASH_OUT_ATOL and e_m <= STATS_ATOL
                and e_l <= L_RTOL and exact0, f"K1 {name}")
        worst = max(worst, e_out)

    q, k, v, qpos, kpos, window = cases["serve shape B4 S1024"]
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    ms = time_ms(lambda: attention_ops.flash_forward(q, k, v, qpos, kpos))
    plain_ms = time_ms(lambda: attention_ref.flash_forward_ref(
        q, k, v, qpos, kpos), reps=5, inner=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True, scale=1.0))
    flops = 2 * 2 * b * h * sq * skv * d * 0.5  # causal: half the products
    n_bytes = (q.numel() + k.numel() + v.numel()) * 2 \
        + b * h * sq * (d + 2) * 4  # out fp32 + m, l
    results["flash_fwd"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms,
                                bound=bound(n_bytes, flops))


def _visible_pairs(qpos, kpos, window=None) -> int:
    """(q, key) pairs of one (batch row, head) that the mask lets through:
    the work a flash kernel's products cannot avoid."""
    from repro_torch.kernels.attention_ref import _mask

    return int(_mask(qpos, kpos, window).sum())


def check_flash_bwd(gen, results):
    """K2 / K3 against ``flash_backward_ref`` on the forward's own (out, m,
    l); rows that see no key get a zero output gradient, as
    ``flash_attention`` gives them (it slices them off)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention_ops, attention_ref

    cases = {
        "train shape B4 S793 (padded to 1024)":
            _flash_case(gen, 4, 793, 20, 5),
        "padded q tail S777 + kv_valid_len 700":
            _flash_case(gen, 2, 777, 20, 5, kv_valid_len=700),
        "window 256": _flash_case(gen, 1, 1024, 20, 5, window=256),
        "ragged tiles S100": _flash_case(gen, 1, 100, 20, 5),
    }
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, (q, k, v, qpos, kpos, window) in cases.items():
        out, m, l = attention_ops.flash_forward(q, k, v, qpos, kpos,
                                                window=window)
        out = out.bfloat16()
        go = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
        go = go * (l > 0)  # rows that see no key: zero gradient
        di = (go.float() * out.float()).sum(-1, keepdim=True)
        args = (q, k, v, go, m, l, di, qpos, kpos)
        dq = attention_ops.flash_backward_dq(*args, window=window)
        dk, dv = attention_ops.flash_backward_dkv(*args, window=window)
        rq, rk, rv = attention_ref.flash_backward_ref(*args, window=window)
        torch.cuda.synchronize()
        errs = {n: max_err(a, r) / float(r.abs().max())
                for n, a, r in (("dq", dq, rq), ("dk", dk, rk),
                                ("dv", dv, rv))}
        print(f"[kernels] K2/K3 flash_bwd {name}: max|x-plain|/max|plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (tol {FLASH_BWD_RTOL})")
        require(all(e <= FLASH_BWD_RTOL for e in errs.values()),
                f"K2/K3 {name}: {errs}")
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], max_err(dq, rq))
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
                                     max_err(dk, rk), max_err(dv, rv))
        if name.startswith("train"):
            main = args, window

    args, window = main
    q, k, v, go, m, l, di, qpos, kpos = args
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    plain_ms = time_ms(lambda: attention_ref.flash_backward_ref(*args),
                       reps=5, inner=1)
    # the yardstick: SDPA's backward (K2 + K3 together) on a saved graph
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                       enable_gqa=True, scale=1.0)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), go,
                                                 retain_graph=True))
    pairs = b * h * _visible_pairs(qpos, kpos)
    prod = 2 * pairs * d  # FLOPs of one (Sq x Skv x D) product, causal
    n_in = (q.numel() + k.numel() + v.numel() + go.numel()) * 2 \
        + 3 * b * h * sq * 4  # bf16 operands, fp32 m, l, di
    results["flash_bwd_dq"] = dict(
        max_abs_err=worst["flash_bwd_dq"],
        ms=time_ms(lambda: attention_ops.flash_backward_dq(*args)),
        plain_ms=plain_ms, library_ms=lib_ms,
        bound=bound(n_in + q.numel() * 4, 3 * prod))
    results["flash_bwd_dkv"] = dict(
        max_abs_err=worst["flash_bwd_dkv"],
        ms=time_ms(lambda: attention_ops.flash_backward_dkv(*args)),
        plain_ms=plain_ms, library_ms=lib_ms,
        bound=bound(n_in + 2 * b * kh * skv * d * 4, 4 * prod))


def check_wire(gen, results):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rdfsq_stats

    worst_q, worst_d = 0.0, 0.0
    # the serve path ships bf16 at 2 bits (ragged last 1024-column tile);
    # the small fp32 cases cover the other slot widths and a partial word
    cases = {"serve shape 4 x 729*1280, 2 bits, bf16":
             (4, 729 * 1280, 2, torch.bfloat16)}
    for b in (1, 2, 4, 8):
        cases[f"3 x 1001 (partial last word), {b} bits, fp32"] = (
            3, 1001, b, torch.float32)
    for name, (r, c, bits, dtype) in cases.items():
        x = (torch.randn((r, c), generator=gen, device="cuda") * 0.7
             + 0.1).to(dtype)
        x[0, :7] = 25.0  # outliers: the 3-sigma clip is active
        lo, hi = rdfsq_stats(x)
        stats = torch.cat([lo, hi], 1).float()
        words = ops.quantize_kernel(x, stats, bits)
        ref_words = ops.quantize_plain(x, stats, bits)
        torch.cuda.synchronize()
        same = torch.equal(words, ref_words)
        n_diff = int((words != ref_words).sum())
        e_q = max_err(words, ref_words)
        st16 = stats.half().float()
        y = ops.dequantize_kernel(words, st16, bits, c, dtype)
        ref_y = ops.dequantize_plain(words, st16, bits, c, dtype)
        torch.cuda.synchronize()
        e_d = max_err(y, ref_y)
        print(f"[kernels] K4 rdfsq_quantize {name}: words bit-identical "
              f"{same} ({n_diff} differing bytes of {words.numel()}); "
              f"K5 rdfsq_dequantize max|out-plain| {e_d:.3e} (exact: "
              f"{e_d == 0.0})")
        require(same and e_d == 0.0, f"K4/K5 {name}")
        worst_q = max(worst_q, e_q)
        worst_d = max(worst_d, e_d)
        if name.startswith("serve"):
            main = (x, stats, words, st16, r, c, bits)

    x, stats, words, st16, r, c, bits = main
    results["rdfsq_quantize"] = dict(
        max_abs_err=worst_q,
        ms=time_ms(lambda: ops.quantize_kernel(x, stats, bits)),
        plain_ms=time_ms(lambda: ops.quantize_plain(x, stats, bits),
                         reps=5, inner=1),
        library_ms=None, bound=bound(r * c * (2 + bits / 8)))
    results["rdfsq_dequantize"] = dict(
        max_abs_err=worst_d,
        ms=time_ms(lambda: ops.dequantize_kernel(words, st16, bits, c,
                                                 torch.bfloat16)),
        plain_ms=time_ms(lambda: ops.dequantize_plain(
            words, st16, bits, c, torch.bfloat16), reps=5, inner=1),
        library_ms=None, bound=bound(r * c * (bits / 8 + 2)))


def check_decode(gen, results):
    import torch
    from repro_torch.kernels import attention_ops, attention_ref

    dev = "cuda"
    s, kh, g, d, pg, n_pages, npp = 4, 5, 4, 64, 16, 433, 64
    k_pool = torch.randn((n_pages, pg, kh, d), generator=gen,
                         device=dev).bfloat16()
    v_pool = torch.randn((n_pages, pg, kh, d), generator=gen,
                         device=dev).bfloat16()
    pos_pool = torch.full((n_pages, pg), -1, dtype=torch.int32, device=dev)
    page_table = torch.full((s, npp), -1, dtype=torch.int32, device=dev)
    # slot 0: 854 tokens; slot 1: 500 tokens with an unallocated (-1) page
    # in its table; slot 2: inactive (qpos = -1); slot 3: 100 tokens
    qpos = torch.tensor([853, 499, -1, 99], dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(0)) + 1
    nxt = 0
    for slot, n_tok in ((0, 854), (1, 500), (3, 100)):
        for j in range(-(-n_tok // pg)):
            page = int(perm[nxt])
            nxt += 1
            page_table[slot, j] = page
            ln = min(pg, n_tok - j * pg)
            pos_pool[page, :ln] = torch.arange(j * pg, j * pg + ln,
                                               dtype=torch.int32)
    page_table[1, 5] = -1
    qf = (torch.randn((s, kh, g, d), generator=gen, device=dev)
          * d ** -0.5).bfloat16()
    err = 0.0
    for window in (None, 200):
        out = attention_ops.decode_paged(qf, k_pool, v_pool, pos_pool,
                                         page_table, qpos, window=window)
        ref = attention_ref.decode_attention_paged_ref(
            qf, k_pool, v_pool, pos_pool, page_table, qpos, window=window)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        inactive0 = bool((out[2] == 0).all())
        print(f"[kernels] K8 decode_paged S4 KH5 G4 pg16 npp64 (a -1 page, "
              f"an inactive slot), window {window}: max|out-plain| {e:.3e} "
              f"(tol {DECODE_ATOL}), inactive slot exact 0: {inactive0}")
        require(e <= DECODE_ATOL and inactive0, f"K8 window {window}")
        err = max(err, e)

    # bytes the kernel must read: K and V of every page with a visible
    # key, the positions of every table entry, the table, q; out written
    live = 0
    for slot in range(s):
        for j in range(npp):
            p = int(page_table[slot, j])
            if p >= 0 and int(qpos[slot]) >= 0 and bool(
                    ((pos_pool[p] >= 0) & (pos_pool[p] <= qpos[slot])).any()):
                live += 1
    n_bytes = (live * pg * kh * d * 2 * 2 + s * npp * pg * 4 + s * npp * 4
               + qf.numel() * 2 + out.numel() * 4)
    results["decode_paged"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attention_ops.decode_paged(
            qf, k_pool, v_pool, pos_pool, page_table, qpos)),
        plain_ms=time_ms(lambda: attention_ref.decode_attention_paged_ref(
            qf, k_pool, v_pool, pos_pool, page_table, qpos), reps=5,
            inner=1),
        library_ms=None, bound=bound(n_bytes))


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    check_flash(gen, results)
    check_flash_bwd(gen, results)
    check_wire(gen, results)
    check_decode(gen, results)
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[kernels] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, library {lib} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})")
    return results


# ---------------------------------------------------------------------------
# phase 3: the split-serve engine at full width
# ---------------------------------------------------------------------------

def _requests(cfg, n, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    img_gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        plen = int(torch.randint(16, 97, (1,), generator=gen))
        max_new = int(torch.randint(16, 33, (1,), generator=gen))
        toks = torch.randint(1, cfg.vocab_size, (plen,), generator=gen)
        img = torch.randn((cfg.n_image_tokens, cfg.d_vision),
                          generator=img_gen, device="cuda")
        out.append((toks.tolist(), max_new, img))
    return out


def phase_serve(cfg, params):
    import torch
    from repro_torch.kernels import build
    from repro_torch.serve.engine import ServeEngine

    page_size, n_slots = 16, 4
    reqs = _requests(cfg, 8, seed=7)
    need = sum(-(-(cfg.n_image_tokens + len(t) + m) // page_size)
               for t, m, _ in reqs)

    def engine():
        return ServeEngine(params, cfg, n_slots=n_slots, page_size=page_size,
                           n_pages=1 + need, split_wire=cfg.split.quant)

    warm = engine()  # first-call set-up (cuBLAS, allocator) off the clock
    warm.submit(reqs[0][0], max_new=2, image_embeds=reqs[0][2])
    warm.run()
    del warm

    eng = engine()
    rids = [eng.submit(t, max_new=m, image_embeds=img) for t, m, img in reqs]
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)

    st = eng.stats
    for rid, (_, m, _) in zip(rids, reqs):
        r = eng.request(rid)
        require(r.state == "done" and len(r.out) == m,
                f"request {rid}: {r.state}, {len(r.out)} of {m} tokens")
    eng.page_pool.check_invariants()
    require(eng.page_pool.n_live == 0, "pages still live after the run")
    n_pb, n_dt = st["prefill_batches"], st["decode_ticks"]
    row_bytes = -(-cfg.n_image_tokens * cfg.d_model * 2 // 8) + 2 * 2
    require(st["wire_bytes"] == st["prefill_rows"] * row_bytes,
            f"wire bytes {st}")
    bf16_bytes = st["prefill_rows"] * cfg.n_image_tokens * cfg.d_model * 2
    n_layers = cfg.n_layers
    expect = dict(flash_fwd=n_layers * n_pb, flash_bwd_dq=0,
                  flash_bwd_dkv=0, rdfsq_quantize=n_pb,
                  rdfsq_dequantize=n_pb, decode_paged=n_layers * n_dt)
    print(f"[serve] launches {launches}, expected {expect}")
    require(launches == expect and all(launches[k] for k in (
        "flash_fwd", "rdfsq_quantize", "rdfsq_dequantize", "decode_paged")),
            f"launches {launches}, expected {expect}")
    print(f"[serve] {len(reqs)} requests, {st['tokens_emitted']} tokens in "
          f"{wall:.3f} s: {st['tokens_emitted'] / wall:.1f} tokens/s; "
          f"{n_pb} prefill batches ({st['prefill_rows']} rows), "
          f"{1e3 * st['prefill_seconds'] / n_pb:.2f} ms per prefill batch; "
          f"{n_dt} decode ticks, "
          f"{1e3 * st['decode_seconds'] / n_dt:.2f} ms per tick")
    print(f"[serve] wire_bytes {st['wire_bytes']} = {st['prefill_rows']} "
          f"rows x {row_bytes} B; bf16 connector bytes {bf16_bytes}; ratio "
          f"{st['wire_bytes'] / bf16_bytes:.6f}")
    return launches, reqs


# ---------------------------------------------------------------------------
# phase 4: parity of the card path with the CPU fp32 path
# ---------------------------------------------------------------------------

def phase_parity(cfg, params, req):
    import torch
    from repro_torch.core import quantizers
    from repro_torch.models.layers.mlp import mlp_forward
    from repro_torch.serve import decode as sd
    from repro_torch.serve.paged import next_pow2

    toks, _, img = req
    n_img, pg = cfg.n_image_tokens, 16
    lb = next_pow2(-(-(n_img + len(toks)) // pg)) * pg
    tokens = torch.zeros((1, lb - n_img), dtype=torch.long)
    tokens[0, :len(toks)] = torch.tensor(toks)
    with torch.inference_mode():
        # the wire runs once, on the card; both paths embed its output
        feats = mlp_forward(params["connector"], img[None].bfloat16())
        payload = quantizers.encode(cfg.split.quant, feats)
        shipped = quantizers.decode(cfg.split.quant, payload)
    gpu, _ = sd.prefill(params, cfg, dict(tokens=tokens.cuda(),
                                          image_features=shipped), lb)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = _tree(params, lambda t: t.float().cpu())
    cpu, _ = sd.prefill(params32, cfg32,
                        dict(tokens=tokens,
                             image_features=shipped.float().cpu()), lb)
    n = n_img + len(toks)
    g = gpu[0, :n].float().cpu()
    c = cpu[0, :n]
    rel = float((g - c).norm() / c.norm())
    top2 = torch.topk(c[-1], 2).values
    agree = int(g[-1].argmax()) == int(c[-1].argmax())
    print(f"[parity] prefill logits, {n} positions: relative error "
          f"{rel:.3e} (tol {PARITY_RTOL}); last-position argmax card "
          f"{int(g[-1].argmax())} cpu {int(c[-1].argmax())} agree {agree} "
          f"(cpu top-2 gap {float(top2[0] - top2[1]):.4f})")
    require(math.isfinite(rel) and rel < PARITY_RTOL and agree,
            f"parity: rel {rel}, argmax agree {agree}")


# ---------------------------------------------------------------------------
# phase 5: the training step at full width
# ---------------------------------------------------------------------------

def phase_train(cfg):
    """30 steps of the paper's training step; returns the launch counts."""
    import torch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import build
    from repro_torch.models.transformer import cdtype, layer_forward_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.utils.tree import tree_count

    seq = cfg.n_image_tokens + TRAIN_TEXT
    data = make_pipeline(cfg, TRAIN_BATCH, seq, seed=0)
    batches = [next(data) for _ in range(TRAIN_STEPS)]  # set-up, off clock
    opt = AdamWConfig(lr=1e-3)
    state = init_state(cfg, opt, seed=0)
    step_fn = make_train_step(cfg, opt, total_steps=TRAIN_STEPS)
    print(f"[train] full-width {cfg.name}: {tree_count(state.params)} "
          f"parameters, remat {cfg.remat}, {cfg.split.quant.method} "
          f"{cfg.split.quant.bits}-bit compressor at cut "
          f"{cfg.split.cut_layer}; {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{seq} positions")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    times, ces, losses = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
        ces.append(float(m["ce"]))
    torch.cuda.synchronize()
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()

    carry = torch.empty((TRAIN_BATCH, seq, cfg.d_model), dtype=cdtype(cfg),
                        device="meta")
    per_step = layer_forward_count(cfg, carry)
    expect = dict(flash_fwd=per_step * TRAIN_STEPS,
                  flash_bwd_dq=cfg.n_layers * TRAIN_STEPS,
                  flash_bwd_dkv=cfg.n_layers * TRAIN_STEPS,
                  rdfsq_quantize=0, rdfsq_dequantize=0, decode_paged=0)
    print(f"[train] launches {launches}, expected {expect} (K1: "
          f"{per_step} layer forwards per step under the remat policy)")
    require(launches == expect, f"train launches {launches}, expected "
            f"{expect}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    first, last = statistics.mean(ces[:5]), statistics.mean(ces[-5:])
    print(f"[train] CE mean of the first 5 steps {first:.4f}, of the last 5 "
          f"{last:.4f}; losses " + " ".join(f"{x:.4f}" for x in losses))
    require(last < first, f"CE did not fall: {first} -> {last}")
    steady = statistics.median(times[1:])
    print(f"[train] {1e3 * steady:.2f} ms per step (median of steps 2-"
          f"{TRAIN_STEPS}; first step {1e3 * times[0]:.2f} ms), "
          f"{TRAIN_BATCH * seq / steady:.1f} training tokens/s; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB")
    return launches


# ---------------------------------------------------------------------------
# phase 6: one training step on the card against the fp32 CPU path
# ---------------------------------------------------------------------------

def phase_train_parity(cfg, params):
    import torch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.train.loop import batch_to, make_grad_fn
    from repro_torch.utils.tree import tree_flatten_with_path

    batch = next(make_pipeline(cfg, 1, cfg.n_image_tokens + TRAIN_TEXT,
                               seed=1))
    grads, m = make_grad_fn(cfg)(params, batch_to(batch,
                                                  torch.device("cuda")))
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = _tree(params, lambda t: t.float().cpu())
    g32, m32 = make_grad_fn(cfg32)(params32,
                                   batch_to(batch, torch.device("cpu")))
    loss, loss32 = float(m["loss"]), float(m32["loss"])
    rel = abs(loss - loss32) / abs(loss32)
    norm = math.sqrt(sum(float(g.double().square().sum())
                         for _, g in tree_flatten_with_path(grads)))
    norm32 = math.sqrt(sum(float(g.double().square().sum())
                           for _, g in tree_flatten_with_path(g32)))
    cos = {}
    for (path, g), (_, c) in zip(tree_flatten_with_path(grads),
                                 tree_flatten_with_path(g32)):
        a, b = g.double().cpu().reshape(-1), c.double().reshape(-1)
        cos["/".join(path)] = float(a @ b / (a.norm() * b.norm()))
    worst = min(cos, key=cos.get)
    print(f"[train parity] one step, 1 x {cfg.n_image_tokens + TRAIN_TEXT} "
          f"positions: loss card {loss:.5f} cpu {loss32:.5f} (rel "
          f"{rel:.3e}, tol {TRAIN_LOSS_RTOL}); grad norm card {norm:.4f} "
          f"cpu {norm32:.4f}; per-leaf gradient cosine min {cos[worst]:.5f} "
          f"({worst}, tol {GRAD_COS_MIN})")
    print("[train parity] cosines " + " ".join(
        f"{k}={v:.5f}" for k, v in cos.items()))
    require(rel < TRAIN_LOSS_RTOL and cos[worst] >= GRAD_COS_MIN,
            f"train parity: loss rel {rel}, cosines {cos}")


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    results = phase_kernels()

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("tinyllava")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"[serve] full-width {cfg.name}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, bf16; "
          f"weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    serve_launches, reqs = phase_serve(cfg, params)
    phase_parity(cfg, params, reqs[0])
    train_launches = phase_train(cfg)
    phase_train_parity(cfg, params)
    print(f"[launches] per main path: serve {serve_launches}; train "
          f"{train_launches}")

    kernels = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "rdfsq_quantize", "rdfsq_dequantize", "decode_paged"):
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=serve_launches.get(name, 0) + train_launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
