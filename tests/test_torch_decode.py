"""The port's static serve path and int8 KV cache against the JAX
reference, on the CPU: ``quantize_kv_token``, the plain versions of the
decode kernels K6 (ring), K7 (int8 ring) and K9 (int8 paged), the ring
decode layer, ``decode_step``, ``generate``, the int8 ``ServeEngine``, the
``serve_batched`` launcher, and how far bf16 moves a decode step through
the 2-bit cut in each package.

Tolerances: 1e-5 absolute on attention outputs (fp32, sums in another
order); codes, scales and tokens exact.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.quantizers import rdfsq as jrdfsq  # noqa: E402
from repro.kernels import attention_ref as jref  # noqa: E402
from repro.kernels import decode_kernel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.serve import decode as jsd  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core.quantizers import rdfsq as trdfsq  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ATOL = 1e-5
CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()
CFG8 = dataclasses.replace(CFG, kv_cache_bits=8)
TCFG8 = dataclasses.replace(TCFG, kv_cache_bits=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# quantize_kv_token
# ---------------------------------------------------------------------------

def _trap_rows(n: int) -> np.ndarray:
    """``n`` rows of 64 fp32 values on which the division by 127 taken as
    a product with the reciprocal (one ulp off in the fp32 scale) changes
    a code: each holds a value within a few ulps of the rounding boundary
    at code 100.5."""
    rng = np.random.default_rng(1)
    f32 = np.float32
    rows = []
    while len(rows) < n:
        row = (rng.normal(size=64) * 3).astype(f32)
        a = np.abs(row).max()
        exact = a / f32(127) + f32(1e-8)
        recip = a * (f32(1) / f32(127)) + f32(1e-8)
        x = f32(100.5) * exact
        for _ in range(8):
            if np.round(x / exact) != np.round(x / recip):
                row[(np.argmax(np.abs(row)) + 1) % 64] = x
                rows.append(row)
                break
            x = np.nextafter(x, f32(np.inf))
    return np.stack(rows)


def _recip_codes(x: np.ndarray) -> np.ndarray:
    """Codes with the division by 127 taken as a product with the
    reciprocal: what PyTorch computes for a CUDA tensor over a Python
    scalar."""
    f32 = np.float32
    scale = np.abs(x).max(-1) * (f32(1) / f32(127)) + f32(1e-8)
    return np.clip(np.round(x / scale[..., None]), -127, 127)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_kv_token_bit_identical(dtype):
    """Codes and fp16 scales equal the reference's bit for bit, zero rows
    included.  The port divides by 127 with ``div_exact``: on 2 560 rows
    of x3 normals a product with the reciprocal moves 109 fp32 scales by
    one ulp, which here changes no code, so the fp32 case adds rows on
    which it does change one."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(8, 64, 5, 64)) * 3).astype(np.float32)
    x[0, :3] = 0.0  # all-zero rows: scale 1e-8, codes 0
    x[1, 0, 0, :7] = 40.0  # outliers
    if dtype == "float32":
        x[2, 0] = _trap_rows(5)
    jx = jnp.asarray(x, dtype)
    tx = _t(jx.astype(jnp.float32)).to(getattr(torch, dtype))
    jc, js = jattn.quantize_kv_token(jx)
    tc, ts = tattn.quantize_kv_token(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    assert np.all(tc.numpy()[0, :3] == 0)
    if dtype == "float32":  # the input does tell the two divisions apart
        assert np.all((_recip_codes(x[2, 0]) != np.asarray(jc)[2, 0])
                      .any(axis=-1))


# ---------------------------------------------------------------------------
# K6 / K7: the plain ring decode against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _ring(b, length, kh, d, qpos, seed):
    """A ring cache holding, for each row, every position up to its qpos
    that still fits: slot p mod L holds position p (wrapped rings keep the
    last L positions)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, length, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, length, kh, d)).astype(np.float32)
    kpos = np.full((b, length), -1, np.int32)
    for row, qp in enumerate(qpos):
        for p in range(max(0, qp - length + 1), qp + 1):
            kpos[row, p % length] = p
    return k, v, kpos


# (L, block the Pallas kernel takes, qpos per row, window); rows at
# different qpos, one that has wrapped, one with no visible key
RING_CASES = {
    "plain L32": (32, 16, [5, 31, 17], None),
    "window": (32, 8, [30, 12, 31], 7),
    "wrapped": (16, 8, [40, 15, 23], None),
    "wrapped + window": (16, 4, [40, 3, 29], 5),
    "prime L37": (37, 37, [36, 80, 2], None),
    "no visible key": (16, 8, [9, -1, 0], None),
}


def _ring_operands(name):
    length, block, qpos, window = RING_CASES[name]
    b, kh, g, d = len(qpos), 2, 3, 16
    k, v, kpos = _ring(b, length, kh, d, [max(q, 0) for q in qpos], seed=1)
    qpos = np.asarray(qpos, np.int32)
    kpos[qpos < 0] = -1
    qf = (np.random.default_rng(2).normal(size=(b, kh, g, d))
          / np.sqrt(d)).astype(np.float32)
    return qf, k, v, kpos, qpos, window, block


def _seen(kpos, qpos, window):
    valid = (kpos >= 0) & (kpos <= qpos[:, None])
    if window is not None:
        valid &= qpos[:, None] - kpos < window
    return valid.any(axis=1)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_decode_plain_matches_reference(name):
    qf, k, v, kpos, qpos, window, block = _ring_operands(name)
    j = [jnp.asarray(a) for a in (qf, k, v, kpos, qpos)]
    jk = decode_kernel.decode(*j[:4], j[4].reshape(-1, 1), window=window,
                              block=block, interpret=True)
    jr = jref.decode_attention_ref(*j, window=window)
    out = tops.decode(*[_t(a) for a in (qf, k, v, kpos, qpos)],
                      window=window).numpy()
    np.testing.assert_allclose(out, np.asarray(jk), atol=ATOL)
    seen = _seen(kpos, qpos, window)
    np.testing.assert_allclose(out[seen], np.asarray(jr)[seen], atol=ATOL)
    assert np.all(out[~seen] == 0.0)  # the port's empty-softmax convention


def _quantized(k, v):
    kc, ks = jattn.quantize_kv_token(jnp.asarray(k))
    vc, vs = jattn.quantize_kv_token(jnp.asarray(v))
    return [np.asarray(a) for a in (kc, vc, ks, vs)]


@pytest.mark.parametrize("name", list(RING_CASES))
def test_decode_q8_plain_matches_reference(name):
    qf, k, v, kpos, qpos, window, block = _ring_operands(name)
    kc, vc, ks, vs = _quantized(k, v)
    j = [jnp.asarray(a) for a in (qf, kc, vc, ks, vs, kpos, qpos)]
    jk = decode_kernel.decode_q8(
        j[0], j[1], j[2], j[3].astype(jnp.float32).transpose(0, 2, 1),
        j[4].astype(jnp.float32).transpose(0, 2, 1), j[5],
        j[6].reshape(-1, 1), window=window, block=block, interpret=True)
    jr = jref.decode_attention_q8_ref(*j, window=window)
    out = tops.decode_q8(*[_t(a) for a in (qf, kc, vc, ks, vs, kpos, qpos)],
                         window=window).numpy()
    np.testing.assert_allclose(out, np.asarray(jk), atol=ATOL)
    seen = _seen(kpos, qpos, window)
    np.testing.assert_allclose(out[seen], np.asarray(jr)[seen], atol=ATOL)
    assert np.all(out[~seen] == 0.0)


def test_decode_q8_rounds_p_times_v_scale_in_q_dtype():
    """bf16 operands: (p * v_scale) is rounded to bf16 before the PV dot,
    as the reference's einsum on ``pv.astype(qf.dtype)``."""
    qf, k, v, kpos, qpos, window, _ = _ring_operands("wrapped")
    kc, vc, ks, vs = _quantized(k, v)
    jq = jnp.asarray(qf, jnp.bfloat16)
    jr = jref.decode_attention_q8_ref(jq, *[jnp.asarray(a) for a in (
        kc, vc, ks, vs, kpos, qpos)], window=window)
    tq = _t(jq.astype(jnp.float32)).bfloat16()
    out = tops.decode_q8(tq, *[_t(a) for a in (kc, vc, ks, vs, kpos, qpos)],
                         window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), atol=ATOL)


# ---------------------------------------------------------------------------
# K9: the plain paged int8 decode
# ---------------------------------------------------------------------------

def _paged_q8(window):
    rng = np.random.default_rng(4)
    p, pg, kh, g, d, npp = 8, 4, 2, 3, 16, 3
    pos = np.full((p, pg), -1, np.int32)
    # slot 0: 10 tokens on pages 1, 2, 3; slot 1: 6 tokens on pages 4, 5
    # with a -1 hole before page 5; slot 2: inactive
    pt = np.array([[1, 2, 3], [4, -1, 5], [-1, -1, -1]], np.int32)
    for j, page in enumerate((1, 2, 3)):
        pos[page] = np.arange(j * pg, (j + 1) * pg)
    pos[3, 2:] = -1
    pos[4] = np.arange(0, pg)
    pos[5] = np.arange(2 * pg, 3 * pg)
    qpos = np.array([9, 10, -1], np.int32)
    kc, vc, ks, vs = _quantized(rng.normal(size=(p, pg, kh, d)) * 2,
                                rng.normal(size=(p, pg, kh, d)))
    qf = (rng.normal(size=(3, kh, g, d)) / np.sqrt(d)).astype(np.float32)
    return qf, kc, vc, ks, vs, pos, pt, qpos


@pytest.mark.parametrize("window", [None, 5])
def test_decode_paged_q8_plain_matches_reference(window):
    qf, kc, vc, ks, vs, pos, pt, qpos = _paged_q8(window)
    j = [jnp.asarray(a) for a in (qf, kc, vc, ks, vs, pos, pt, qpos)]
    jk = decode_kernel.decode_paged_q8(
        j[0], j[1], j[2], j[3].astype(jnp.float32).transpose(0, 2, 1),
        j[4].astype(jnp.float32).transpose(0, 2, 1), j[5], j[6],
        j[7].reshape(-1, 1), window=window, interpret=True)
    jr = jref.decode_attention_paged_q8_ref(*j, window=window)
    out = tops.decode_paged_q8(*[_t(a) for a in (qf, kc, vc, ks, vs, pos, pt,
                                                 qpos)], window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), atol=ATOL)
    assert np.all(out.numpy()[2] == 0.0)  # inactive slot: exact zero


# ---------------------------------------------------------------------------
# the ring decode layer
# ---------------------------------------------------------------------------

def _attn_params(rng, dm, h, kh, d):
    return {k: (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
            for k, shape in (("wq", (dm, h * d)), ("wk", (dm, kh * d)),
                             ("wv", (dm, kh * d)), ("wo", (h * d, dm)))}


@pytest.mark.parametrize("bits", [16, 8])
def test_gqa_decode_ring_matches_paged_and_reference(bits):
    """Six tokens through a ring cache and through a paged pool give the
    same outputs (the port's twin of the reference's ring-vs-paged test),
    and the ring matches the reference's ``gqa_decode`` leaf by leaf."""
    rng = np.random.default_rng(0)
    s, h, kh, d, dm, pg, npp = 2, 4, 2, 16, 32, 4, 4
    p = _attn_params(rng, dm, h, kh, d)
    tp = {k: _t(v) for k, v in p.items()}
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=d, rope_theta=1e4)
    ring = tattn.init_kv_cache(s, pg * npp, kh, d, dtype=torch.float32,
                               bits=bits, device="cpu")
    pool = tattn.init_paged_kv_pool(1 + s * npp, pg, kh, d,
                                    dtype=torch.float32, bits=bits,
                                    device="cpu")
    jring = jattn.init_kv_cache(s, pg * npp, kh, d, dtype=jnp.float32,
                                bits=bits)
    pt = _t(1 + np.arange(s * npp).reshape(s, npp).astype(np.int32))
    for t in range(6):
        x = rng.normal(size=(s, 1, dm)).astype(np.float32)
        qpos = np.full((s,), t, np.int32)
        yr, ring2 = tattn.gqa_decode(tp, _t(x), ring, qpos=_t(qpos), **kw)
        yp, _ = tattn.gqa_decode_paged(tp, _t(x), pool, qpos=_t(qpos),
                                       page_table=pt, **kw)
        jy, jring = jattn.gqa_decode({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x), jring,
                                     qpos=jnp.asarray(qpos), **kw)
        assert ring2 is ring  # written in place
        np.testing.assert_array_equal(yr.numpy(), yp.numpy())
        np.testing.assert_allclose(yr.numpy(), np.asarray(jy), atol=ATOL)
    assert set(ring) == set(jring)
    for leaf in ring:
        if ring[leaf].dtype == torch.float32:
            np.testing.assert_allclose(ring[leaf].numpy(),
                                       np.asarray(jring[leaf]), atol=ATOL)
        else:  # positions and int8 codes exact, fp16 scales bit for bit
            np.testing.assert_array_equal(ring[leaf].numpy(),
                                          np.asarray(jring[leaf]))


# ---------------------------------------------------------------------------
# the model: decode_step, generate, the int8 engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jtf.init_params(jax.random.PRNGKey(0), CFG)
    return jp, from_jax_params(jp, "cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    b, plen = 3, 9
    return dict(
        image_embeds=rng.normal(size=(b, CFG.n_image_tokens, CFG.d_vision))
        .astype(np.float32),
        tokens=rng.integers(1, CFG.vocab_size, (b, plen)).astype(np.int32))


def _generate_both(params, prompts, bits, **kw):
    jp, tp = params
    cfg, tcfg = (CFG8, TCFG8) if bits == 8 else (CFG, TCFG)
    ref = np.asarray(jsd.generate(
        jp, cfg, {k: jnp.asarray(v) for k, v in prompts.items()}, **kw))
    out = tsd.generate(tp, tcfg, {k: _t(v) for k, v in prompts.items()},
                       **kw).numpy()
    return out, ref


GEN_CASES = {
    "16-bit": (16, dict(n_new=8, cache_len=40)),
    "int8": (8, dict(n_new=8, cache_len=40)),
    "16-bit, window 11 < history": (16, dict(n_new=8, cache_len=11,
                                             window=11)),
    "int8, window 11 < history": (8, dict(n_new=8, cache_len=11,
                                          window=11)),
}


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_token_exact_vs_reference(params, prompts, name):
    """Greedy generate, prefill included, token for token against the
    reference's (fp32 compute; the 16-bit cache holds the compute dtype).
    The windowed ring is shorter than the 25-position prompt, so the
    prefill keeps only its last 11 positions and every step wraps."""
    bits, kw = GEN_CASES[name]
    out, ref = _generate_both(params, prompts, bits, **kw)
    assert out.shape == (3, kw["n_new"])
    np.testing.assert_array_equal(out, ref)


def test_generate_eos_freezes_finished_rows(params, prompts):
    base, _ = _generate_both(params, prompts, 16, n_new=8, cache_len=40)
    eos = int(base[0][2])
    out, ref = _generate_both(params, prompts, 16, n_new=8, cache_len=40,
                              eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(out, ref)
    i0 = list(base[0]).index(eos)
    np.testing.assert_array_equal(out[0][:i0 + 1], base[0][:i0 + 1])
    assert np.all(out[0][i0 + 1:] == 0)


def test_generate_temperature_is_seeded(params, prompts):
    _, tp = params
    batch = {k: _t(v) for k, v in prompts.items()}
    a, b, c = (tsd.generate(tp, TCFG, batch, n_new=6, cache_len=40,
                            temperature=1.0, seed=s) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("bits", [16, 8])
def test_decode_step_updates_caches_in_place(params, prompts, bits):
    """The port's twin of the reference's donation test: a step writes the
    same buffers (same ``data_ptr``) and returns them."""
    _, tp = params
    tcfg = TCFG8 if bits == 8 else TCFG
    batch = {k: _t(v) for k, v in prompts.items()}
    _, caches = tsd.prefill(tp, tcfg, batch, 40)
    leaves = {(side, seg, k): v for side in caches
              for seg in caches[side] for k, v in caches[side][seg].items()}
    before = {key: (t.data_ptr(), t.clone()) for key, t in leaves.items()}
    qpos = torch.full((3,), TCFG.n_image_tokens + 9, dtype=torch.int32)
    step = tsd.make_serve_step(tcfg)
    _, new = step(tp, caches, dict(tokens=batch["tokens"][:, :1]), qpos)
    assert new is caches
    for (side, seg, k), (ptr, old) in before.items():
        t = new[side][seg][k]
        assert t.data_ptr() == ptr
        assert not torch.equal(t, old)  # the new token's slot was written
    if bits == 8:
        assert {"k_scale", "v_scale"} <= set(new["server"]["seg0"])


def test_init_caches_match_reference():
    for bits, (cfg, tcfg) in ((16, (CFG, TCFG)), (8, (CFG8, TCFG8))):
        jc = jtf.init_caches(cfg, 2, 12, dtype=jnp.float32)
        tc = ttf.init_caches(tcfg, 2, 12, dtype=torch.float32, device="cpu")
        for side in ("client", "server"):
            for seg in jc[side]:
                assert set(tc[side][seg]) == set(jc[side][seg]), bits
                for k, v in jc[side][seg].items():
                    t = tc[side][seg][k]
                    assert tuple(t.shape) == v.shape, (bits, k)
                    assert str(t.dtype).split(".")[1] == str(v.dtype), k
                    np.testing.assert_array_equal(t.numpy(), np.asarray(v))


def test_insert_prefill_moves_int8_scales(params, prompts):
    """``insert_prefill`` moves every cache leaf, so an int8 prefill's codes
    and fp16 scales land in the pools' pages as they are, though it has no
    int8 branch; positions past a row's valid length become -1."""
    from repro_torch.serve import paged

    _, tp = params
    batch = {k: _t(v)[:2] for k, v in prompts.items()}
    pg, npb = 8, 4
    _, caches = tsd.prefill(tp, TCFG8, batch, pg * npb)
    pools = paged.init_pools(TCFG8, 1 + 2 * npb, pg, device="cpu")
    rows = torch.arange(1, 1 + 2 * npb, dtype=torch.int32).reshape(2, npb)
    valid = torch.tensor([25, 20], dtype=torch.int32)
    paged.insert_prefill(pools, caches, rows, valid)
    for side in pools:
        for seg, pool in pools[side].items():
            assert set(pool) == {"k", "v", "k_scale", "v_scale", "pos"}
            for key, leaf in pool.items():
                got = leaf[:, rows.long()].flatten(2, 3)  # (n, 2, 32, ...)
                want = caches[side][seg][key]
                if key == "pos":
                    keep = torch.arange(pg * npb) < valid[:, None]
                    want = torch.where(keep, want, -1)
                assert torch.equal(got, want), (side, seg, key)
            assert bool((pool["k_scale"][:, 1:] > 0).any())


@pytest.fixture(scope="module")
def engine_case():
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(5):
        plen = int(rng.integers(3, 20))
        reqs.append((rng.integers(1, CFG.vocab_size, plen).tolist(),
                     int(rng.integers(2, 7)),
                     rng.normal(size=(CFG.n_image_tokens, CFG.d_vision))
                     .astype(np.float32)))
    need = sum(-(-(CFG.n_image_tokens + len(t) + m) // 8)
               for t, m, _ in reqs)
    return reqs, 1 + need


def _run_engine(cls, params, cfg, reqs, n_pages, **kw):
    eng = cls(params, cfg, n_slots=3, page_size=8, n_pages=n_pages, **kw)
    rids = [eng.submit(t, max_new=m, image_embeds=img) for t, m, img in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


def test_int8_engine_token_exact_vs_reference(params, engine_case):
    """The int8-pool engine (prefill ring caches quantized, moved into the
    pools leaf by leaf, scales included; K9's plain version each tick)
    against the reference's int8 engine, with the 2-bit wire."""
    jp, tp = params
    reqs, n_pages = engine_case
    ref, jeng = _run_engine(JaxServeEngine, jp, CFG8, reqs, n_pages,
                            split_wire=CFG.split.quant)
    out, teng = _run_engine(ServeEngine, tp, TCFG8, reqs, n_pages,
                            device="cpu", split_wire=TCFG.split.quant)
    assert out == ref
    assert teng.stats["wire_bytes"] == jeng.stats["wire_bytes"]
    pools = teng.pools["server"]["seg0"]
    assert pools["k"].dtype == torch.int8
    assert pools["k_scale"].dtype == torch.float16
    assert bool((pools["k_scale"] > 0).any())  # the scales were moved too
    assert teng.page_pool.n_live == 0


def test_int8_engine_token_exact_vs_reference_generate(params):
    """Lockstep: four equal-length requests through the int8 engine give
    the reference's int8 ``generate`` tokens (the port's twin of the
    reference's engine-vs-generate gate).  16 image + 16 prompt positions
    fill the engine's prefill bucket (8 pages of 4) exactly: with padded
    positions the RD-FSQ roundtrip at the cut takes its per-row statistics
    over the padding too, and the reference's own engine and ``generate``
    part ways."""
    jp, tp = params
    b, plen, n_new, pg = 4, 16, 6, 4
    rng = np.random.default_rng(1)
    toks = rng.integers(1, CFG.vocab_size, (b, plen)).astype(np.int32)
    imgs = rng.normal(size=(b, CFG.n_image_tokens, CFG.d_vision)).astype(
        np.float32)
    n_img = CFG.n_image_tokens
    ref = np.asarray(jsd.generate(
        jp, CFG8, dict(tokens=jnp.asarray(toks),
                       image_embeds=jnp.asarray(imgs)),
        n_new=n_new, cache_len=n_img + plen + n_new))
    eng = ServeEngine(tp, TCFG8, n_slots=b, page_size=pg,
                      n_pages=1 + b * -(-(n_img + plen + n_new) // pg),
                      device="cpu")
    rids = [eng.submit(list(toks[i]), max_new=n_new, image_embeds=imgs[i])
            for i in range(b)]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r] for r in rids]), ref)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--window", "20"], ["--engine"],
                                   ["--engine", "--split-serve"]],
                         ids=["static", "static window", "engine",
                              "engine split-serve"])
def test_serve_batched_launcher_runs(capsys, extra):
    from repro_torch.launch import serve_batched

    serve_batched.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "5", "--new-tokens", "3"] + extra)
    text = capsys.readouterr().out
    if "--engine" in extra:
        assert "engine: 2 requests" in text
        assert ("wire:" in text) == ("--split-serve" in extra)
    else:
        assert "prefill(2x5)" in text and "decoded 3 tokens" in text


def test_serve_batched_weight_quant_raises(capsys):
    """``--weight-quant`` no longer raises (M10 is ported): the launcher
    serves from GPTQ-quantized packed weights and reports their bytes."""
    from repro_torch.launch import serve_batched

    serve_batched.main(["--device", "cpu", "--engine", "--weight-quant",
                        "int4", "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"])
    text = capsys.readouterr().out
    assert "engine: 2 requests" in text
    assert "int4 weights:" in text and "B packed vs" in text


# ---------------------------------------------------------------------------
# bf16 through the 2-bit cut: the reference's own departure
# ---------------------------------------------------------------------------

CUT_ROWS = 16  # 2 rows give one-sample ratios of 0.45 - 2.25


def _bf16_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def cut_runs():
    """One teacher-forced decode step after a prefill, in bf16 and in fp32,
    in both packages, with the 2-bit cut off and on (tinyllava.reduced(),
    the cut after layer 1).  The step's token is the fp32 reference's pick
    on every run.  Returns per cut: the relative L2 departure of each
    package's bf16 step logits from its own fp32 ones, and with the cut on
    the RD-FSQ codes of the decode token's rows in each run."""
    rng = np.random.default_rng(11)
    n_tok = 9
    img = rng.normal(size=(CUT_ROWS, CFG.n_image_tokens, CFG.d_vision)
                     ).astype(np.float32)
    toks = rng.integers(1, CFG.vocab_size, (CUT_ROWS, n_tok)).astype(
        np.int32)
    jp32 = jtf.init_params(jax.random.PRNGKey(0), CFG)
    jp = {"float32": jp32, "bfloat16": _bf16_tree(jp32)}
    tp = {k: from_jax_params(v, "cpu") for k, v in jp.items()}
    n = CFG.n_image_tokens + n_tok
    codes = {"j": [], "t": []}
    quant = {"j": jrdfsq._quantize, "t": trdfsq._quantize}

    def hook(pkg):
        def quantize(cfg, x):
            out = quant[pkg](cfg, x)
            codes[pkg].append(out[2])
            return out
        return quantize

    jrdfsq._quantize, trdfsq._quantize = hook("j"), hook("t")
    try:
        out = {}
        for cut in (False, True):
            logits, rows, tok = {}, {}, None
            for dt in ("float32", "bfloat16"):
                split = dataclasses.replace(CFG.split, enabled=cut)
                jc = dataclasses.replace(CFG, param_dtype=dt,
                                         compute_dtype=dt, split=split)
                tc = dataclasses.replace(TCFG, param_dtype=dt,
                                         compute_dtype=dt, split=split)
                jl, jcache = jsd.prefill(jp[dt], jc, dict(
                    tokens=jnp.asarray(toks), image_embeds=jnp.asarray(img)),
                    n + 1)
                tl, tcache = tsd.prefill(tp[dt], tc, dict(
                    tokens=_t(toks), image_embeds=_t(img)), n + 1)
                if tok is None:  # the fp32 reference's picks
                    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
                codes["j"].clear()
                codes["t"].clear()
                jl, _ = jsd.make_serve_step(jc)(
                    jp[dt], jcache, dict(tokens=jnp.asarray(tok[:, None])),
                    jnp.full((CUT_ROWS,), n, jnp.int32))
                tl, _ = tsd.make_serve_step(tc)(
                    tp[dt], tcache, dict(tokens=_t(tok[:, None])),
                    torch.full((CUT_ROWS,), n, dtype=torch.int32))
                logits[dt] = (np.asarray(jl[:, -1], np.float32),
                              tl[:, -1].float().numpy())
                rows[dt] = {k: [np.asarray(c) for c in v]
                            for k, v in codes.items()}
            out[cut] = dict(
                ref=_rel(logits["bfloat16"][0], logits["float32"][0]),
                port=_rel(logits["bfloat16"][1], logits["float32"][1]),
                fp32=_rel(logits["float32"][1], logits["float32"][0]),
                codes=rows)
        return out
    finally:
        jrdfsq._quantize, trdfsq._quantize = quant["j"], quant["t"]


def test_bf16_cut_departure_is_the_reference_s(cut_runs):
    """bf16 against fp32 for one decode step.  With the cut off both
    packages stay near 1e-2; with it on, each departs several times more
    and the port within a factor 2 of the reference: the amplification is
    the reference's own, not a fault of the port (the reason
    ``chip_smoke.py``'s decode parity check runs with the cut off)."""
    off, on = cut_runs[False], cut_runs[True]
    assert off["fp32"] < 1e-5 and on["fp32"] < 1e-5
    assert off["port"] < 3e-2 and off["ref"] < 3e-2
    assert 0.5 <= on["port"] / on["ref"] <= 2.0
    assert on["port"] > off["port"] and on["ref"] > off["ref"]


def test_bf16_cut_code_flips_match_reference(cut_runs):
    """The code-level count behind the departure: the share of the decode
    token's 2-bit RD-FSQ codes that bf16 moves from their fp32 level, in
    each package.  The fp32 codes of the two packages are equal; bf16
    flips a share of them in both, the two shares within a factor 2."""
    rows = cut_runs[True]["codes"]
    flips = {}
    for pkg in ("j", "t"):
        (c32,), (c16,) = rows["float32"][pkg], rows["bfloat16"][pkg]
        assert c32.shape[:2] == (CUT_ROWS, 1) and c16.shape == c32.shape
        flips[pkg] = float(np.mean(c16 != c32))
    np.testing.assert_array_equal(rows["float32"]["t"][0],
                                  rows["float32"]["j"][0])
    assert flips["j"] > 0 and flips["t"] > 0
    assert 0.5 <= flips["t"] / flips["j"] <= 2.0
