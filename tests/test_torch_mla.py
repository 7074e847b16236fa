"""The port's Multi-head Latent Attention (``models/layers/mla.py``) and the
plain K1 - K3 at MLA's width pair (D, Dv) = (96, 64) against the JAX
reference, on the CPU, in fp32: ``mla_forward`` with its latent cache at
``minicpm3_4b.reduced()`` and at a wider shape that keeps (96, 64);
``mla_decode`` over a wrapped ring; the plain flash forward and backward
against the Pallas kernels in interpret mode and the jnp reference; the
wrappers' and the launch plan's width checks."""
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import attention_ref as jref  # noqa: E402
from repro.kernels import flash_kernel  # noqa: E402
from repro.models.layers import mla as jmla  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.models.layers import mla as tmla  # noqa: E402

ATOL = 1e-5
FAR = 2 ** 30

# (name, d_model, n_heads, q_lora, kv_lora, qk_nope, qk_rope, v): the
# reduced config's MLA (qk 16 + 16, v 16, head_dim 32), a wider one at
# minicpm3_4b's own (96, 64), and the same without the q latent
_RED = get_config("minicpm3_4b").reduced()
MLA_SHAPES = [
    ("reduced", _RED.d_model, _RED.n_heads, _RED.q_lora_rank,
     _RED.kv_lora_rank, _RED.qk_nope_dim, _RED.qk_rope_dim,
     _RED.v_head_dim),
    ("d256 qk64+32 v64", 256, 4, 96, 64, 64, 32, 64),
    ("d256 qk64+32 v64, no q latent", 256, 4, 0, 64, 64, 32, 64),
]


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


def _close(t, j, atol=ATOL):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().float().numpy(), j,
                               atol=atol * max(1.0, float(np.abs(j).max())))


def _mla(shape, seed=0):
    """The reference's MLA parameters at ``shape`` and the port's copy."""
    _, d, h, ql, kvl, dn, dr, dv = shape
    jp = jmla.init_mla_params(jax.random.PRNGKey(seed), d, h, q_lora_rank=ql,
                              kv_lora_rank=kvl, qk_nope_dim=dn,
                              qk_rope_dim=dr, v_head_dim=dv)
    kw = dict(n_heads=h, qk_nope_dim=dn, qk_rope_dim=dr, v_head_dim=dv,
              kv_lora_rank=kvl, rope_theta=1e4)
    return jp, from_jax_params(jp, "cpu"), kw


def test_reduced_config_keeps_the_reference_mla_widths():
    """``minicpm3_4b.reduced()``: qk 16 + 16, v 16, head_dim 32, as the
    reference's, so the CPU tests run the plain K1 - K3 at (32, 16)."""
    from repro_torch.configs import get_config as tget

    red = tget("minicpm3_4b").reduced()
    assert (red.qk_nope_dim, red.qk_rope_dim, red.v_head_dim,
            red.head_dim) == (16, 16, 16, 32)
    assert (red.q_lora_rank, red.kv_lora_rank) == (64, 32)
    full = tget("minicpm3_4b")
    assert (full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim) \
        in tops.FLASH_HEAD_DIMS


@pytest.mark.parametrize("shape", MLA_SHAPES, ids=[s[0] for s in MLA_SHAPES])
def test_init_mla_params_match_reference(shape):
    """Leaf names and shapes of ``init_mla_params`` (2 layers stacked)
    against the reference's, and its scales: fan_in^-1/2, norms at 1."""
    _, d, h, ql, kvl, dn, dr, dv = shape
    jp, _, _ = _mla(shape)
    gen = torch.Generator().manual_seed(0)

    def normal(*s, scale):
        return torch.randn(s, generator=gen) * scale

    def const(value, *s):
        return torch.full(s, value)

    tp = tmla.init_mla_params(2, d, h, normal, const, q_lora_rank=ql,
                              kv_lora_rank=kvl, qk_nope_dim=dn,
                              qk_rope_dim=dr, v_head_dim=dv)
    assert {k: tuple(v.shape[1:]) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert float(tp["wkv_a"].std()) * d ** 0.5 == pytest.approx(1.0,
                                                               abs=0.1)
    assert bool((tp["kv_norm"] == 1).all())


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("shape", MLA_SHAPES, ids=[s[0] for s in MLA_SHAPES])
def test_mla_forward_and_latent_cache_match_reference(shape, window):
    """y and the latent cache (c_kv, k_rope) of ``mla_forward`` against the
    reference's, q/k of width qk_nope + qk_rope and v of width v through
    ``flash_attention`` (the plain K1 on the CPU); positions offset by 3.
    Tolerance 1e-5 relative to max |ref|: fp32 sums in another order."""
    jp, tp, kw = _mla(shape)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 21, shape[1])).astype(np.float32)
    pos = np.arange(3, 24, dtype=np.int32)
    fwd = jax.jit(functools.partial(jmla.mla_forward, window=window,
                                    return_kv=True, **kw))
    jy, (jc, jr) = fwd(jp, jnp.asarray(x), positions=jnp.asarray(pos))
    ty, (tc, tr) = tmla.mla_forward(tp, _t(x), positions=_t(pos),
                                    window=window, return_kv=True, **kw)
    assert tc.shape == (2, 21, shape[4]) and tr.shape == (2, 21, shape[6])
    _close(ty, jy)
    _close(tc, jc)
    _close(tr, jr)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("shape", MLA_SHAPES[:2],
                         ids=[s[0] for s in MLA_SHAPES[:2]])
def test_mla_decode_over_a_wrapped_ring_matches_reference(shape, window):
    """Eight absorbed-weight decode steps over a ring of 10 slots filled by
    a 9-token prefill, so the ring wraps at step 2: each step's y and the
    cache (written in place in the port) against the reference's, weights
    carried by ``from_jax_params``.  A window of 6 masks by position."""
    jp, tp, kw = _mla(shape, seed=2)
    rng = np.random.default_rng(3)
    b, length, p = 2, 10, 9
    x = rng.normal(size=(b, p, shape[1])).astype(np.float32)
    pos = np.arange(p, dtype=np.int32)
    _, (jc, jr) = jax.jit(functools.partial(
        jmla.mla_forward, return_kv=True, **kw))(
            jp, jnp.asarray(x), positions=jnp.asarray(pos))
    step = jax.jit(functools.partial(jmla.mla_decode, window=window, **kw))
    jcache = jmla.init_mla_cache(b, length, shape[4], shape[6],
                                 dtype=jnp.float32)
    jcache = dict(ckv=jcache["ckv"].at[:, :p].set(jc),
                  krope=jcache["krope"].at[:, :p].set(jr),
                  pos=jcache["pos"].at[:, :p].set(jnp.asarray(pos)))
    tcache = {k: _t(v) for k, v in jcache.items()}
    for t in range(8):
        xt = rng.normal(size=(b, 1, shape[1])).astype(np.float32)
        qpos = np.full((b,), p + t, np.int32)
        jy, jcache = step(jp, jnp.asarray(xt), jcache,
                          qpos=jnp.asarray(qpos))
        ty, same = tmla.mla_decode(tp, _t(xt), tcache, qpos=_t(qpos),
                                   window=window, **kw)
        assert same is tcache
        _close(ty, jy)
    for leaf in ("ckv", "krope"):
        _close(tcache[leaf], jcache[leaf])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert int(tcache["pos"].max()) == p + 7 and int(
        tcache["pos"].min()) == p + 7 - length + 1


def test_init_mla_cache_matches_reference():
    j = jmla.init_mla_cache(3, 5, 8, 4, dtype=jnp.bfloat16)
    t = tmla.init_mla_cache(3, 5, 8, 4, dtype=torch.bfloat16, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in t.items()} == {
        k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in j.items()}
    assert bool((t["pos"] == -1).all())


# ---------------------------------------------------------------------------
# the plain K1 - K3 at (96, 64) against the Pallas kernels
# ---------------------------------------------------------------------------

# (sq, skv, h, kh, window, kv_valid_len, chunk) at q/k width 96, v 64
D96_CASES = [
    (48, 48, 2, 2, None, None, 16),   # MLA's G = 1
    (40, 40, 2, 2, None, None, 16),   # padded q / kv tail
    (32, 48, 2, 2, None, 24, 16),     # kv_valid_len + longer kv
    (48, 48, 2, 2, 12, None, 16),     # window
    (48, 48, 4, 2, None, None, 16),   # G = 2
]
D, DV = 96, 64


def _bhsd(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3))


def _operands(sq, skv, h, kh, window, kv_valid_len, chunk, seed=0):
    """Pre-scaled (by D^-1/2), chunk-padded (B, S, H, D / Dv) operands with
    sentinel positions, as the reference's flash_attention builds them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, sq, h, D)).astype(np.float32)
    k = rng.normal(size=(1, skv, kh, D)).astype(np.float32)
    v = rng.normal(size=(1, skv, kh, DV)).astype(np.float32)
    pad_q, pad_kv = (-sq) % chunk, (-skv) % chunk
    qs = np.pad(q * D ** -0.5, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
    k = np.pad(k, ((0, 0), (0, pad_kv), (0, 0), (0, 0)))
    v = np.pad(v, ((0, 0), (0, pad_kv), (0, 0), (0, 0)))
    qpos = np.pad(np.arange(sq, dtype=np.int32), (0, pad_q),
                  constant_values=-FAR)
    kpos = np.full(skv + pad_kv, FAR, np.int32)
    n = min(sq, skv)
    kpos[:n] = np.arange(n)
    if kv_valid_len is not None:
        kpos[kv_valid_len:] = FAR
    return qs, k, v, qpos, kpos


@pytest.mark.parametrize("case", D96_CASES)
def test_flash_forward_plain_d96_v64_matches_reference_kernel(case):
    """(out, m, l) of the plain K1 at (96, 64) against the Pallas kernel
    in interpret mode, on every row that sees a key (rows that see none
    are 0 in the port), and the wrapper against the jnp reference.
    Tolerance 1e-5 relative to max |ref|."""
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case)
    jo, jm, jl = flash_kernel.forward(
        jnp.asarray(_bhsd(qs)), jnp.asarray(_bhsd(k)), jnp.asarray(_bhsd(v)),
        jnp.asarray(qpos.reshape(-1, 1)), jnp.asarray(kpos.reshape(1, -1)),
        window=window, block=chunk, interpret=True)
    to, tm, tl = tops.flash_forward(_t(_bhsd(qs)), _t(_bhsd(k)),
                                    _t(_bhsd(v)), _t(qpos), _t(kpos),
                                    window=window)
    assert to.shape == (1, h, qs.shape[1], DV)
    seen = np.asarray(tl)[..., 0] > 0
    assert seen[:, :, :sq].all() and not seen[:, :, sq:].any()
    _close(torch.as_tensor(to.numpy()[seen]), np.asarray(jo)[seen])
    _close(torch.as_tensor(tm.numpy()[seen]), np.asarray(jm)[seen])
    np.testing.assert_allclose(tl.numpy()[seen], np.asarray(jl)[seen],
                               rtol=ATOL)
    assert np.all(to.numpy()[~seen] == 0)
    jr = jref.flash_reference(jnp.asarray(qs), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(qpos),
                              jnp.asarray(kpos), window, chunk)
    port = tops.flash(_t(qs), _t(k), _t(v), _t(qpos), _t(kpos), window)
    _close(port[:, :sq], np.asarray(jr)[:, :sq])


@pytest.mark.parametrize("case", D96_CASES)
def test_flash_backward_plain_d96_v64_matches_reference_kernels(case):
    """dq (width 96) / dk (96) / dv (64) of the plain K2 / K3 against the
    Pallas backward_dq / backward_dkv in interpret mode and the jnp VJP of
    flash_reference, fed the JAX forward's own (m, l) and di; padded q
    rows get a zero output gradient, as flash_attention gives them."""
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case)
    go = np.random.default_rng(5).normal(
        size=qs.shape[:3] + (DV,)).astype(np.float32)
    go[:, sq:] = 0.0
    jq, jk, jv = (jnp.asarray(_bhsd(a)) for a in (qs, k, v))
    jqp = jnp.asarray(qpos.reshape(-1, 1))
    jkp = jnp.asarray(kpos.reshape(1, -1))
    jo, jm, jl = flash_kernel.forward(jq, jk, jv, jqp, jkp, window=window,
                                      block=chunk, interpret=True)
    gob = _bhsd(go)
    di = np.sum(gob * np.asarray(jo), axis=-1, keepdims=True)
    kw = dict(window=window, block=chunk, interpret=True)
    jdq = flash_kernel.backward_dq(jq, jk, jv, jnp.asarray(gob), jm, jl,
                                   jnp.asarray(di), jqp, jkp, **kw)
    jdk, jdv = flash_kernel.backward_dkv(jq, jk, jv, jnp.asarray(gob), jm,
                                         jl, jnp.asarray(di), jqp, jkp, **kw)
    targs = [_t(_bhsd(a)) for a in (qs, k, v)] + [
        _t(gob), _t(jm), _t(jl), _t(di), _t(qpos), _t(kpos)]
    dq = tops.flash_backward_dq(*targs, window=window)
    dk, dv = tops.flash_backward_dkv(*targs, window=window)
    assert dq.shape[-1] == dk.shape[-1] == D and dv.shape[-1] == DV
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(port, ref)
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_reference(
        a, b_, c, jnp.asarray(qpos), jnp.asarray(kpos), window, chunk),
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))
    for port, ref in zip((dq, dk, dv), vjp(jnp.asarray(go))):
        _close(torch.as_tensor(_bhsd(port.numpy())), ref)


# ---------------------------------------------------------------------------
# width checks and the launch plan at (96, 64)
# ---------------------------------------------------------------------------

def _ops(d, dv, h=4, kh=2):
    q = torch.zeros(1, h, 16, d, dtype=torch.bfloat16)
    k = torch.zeros(1, kh, 16, d, dtype=torch.bfloat16)
    v = torch.zeros(1, kh, 16, dv, dtype=torch.bfloat16)
    pos = torch.arange(16, dtype=torch.int32)
    return q, k, v, pos, pos


def test_flash_checks_take_d96_v64_and_name_the_queued_pairs():
    """The flash checks admit (96, 64), with a (B, H, Sq, 64) output
    gradient (deepseek_v2_236b's (192, 128) and zamba2's (80, 80) are
    compiled too: tests/test_torch_deepseek.py, tests/test_torch_zamba2.py);
    a pair no config needs, (112, 112), says no ROADMAP item queues it;
    any other pair, and q / k widths that differ, raise ``ValueError``."""
    assert (96, 64) in tops.FLASH_HEAD_DIMS
    q, k, v, qpos, kpos = _ops(96, 64)
    go = torch.zeros(1, 4, 16, 64, dtype=torch.bfloat16)
    tops._check_flash("K2", q, k, v, qpos, kpos, go)
    with pytest.raises(ValueError, match="bad GQA shapes"):
        tops._check_flash("K2", q, k, v, qpos, kpos,
                          torch.zeros(1, 4, 16, 96, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no ROADMAP item"):
        tops._check_flash("K1", *_ops(112, 112))
    with pytest.raises(ValueError, match="no ROADMAP item"):
        tops._check_flash("K2", *_ops(112, 112),
                          torch.zeros(1, 4, 16, 112, dtype=torch.bfloat16))
    for d, dv in ((96, 96), (64, 96), (96, 128), (32, 16)):
        with pytest.raises(ValueError, match="head_dim"):
            tops._check_flash("K1", *_ops(d, dv))
    q, _, v, qpos, kpos = _ops(96, 64)
    with pytest.raises(ValueError, match="q and k"):
        tops._check_flash("K1", q, torch.zeros(1, 2, 16, 64,
                                               dtype=torch.bfloat16),
                          v, qpos, kpos)


@pytest.mark.parametrize("shape", [(2, 40, 40, 1024, 1024),
                                   (2, 40, 40, 777, 777),
                                   (1, 4, 2, 100, 100)])
def test_flash_bwd_plan_at_d96_v64(shape):
    """K2 / K3's plan at (96, 64) (minicpm3_4b's training shape, G 1, and
    a G 2 ragged case): 3 ring stages (D + Dv = 160), each tile sized by
    its own width; K3's clusters of G / p blocks, one block at G 1; the
    grid and heads those of any width; the shared memory fits the H100 at
    the shape and at 32k."""
    b, h, kh, sq, skv = shape
    dq, dkv = tops.flash_bwd_plan(b, h, kh, sq, skv, 96, 64)
    nkv64, nq64 = -(-skv // 64), -(-sq // 64)
    assert dq.smem == 1024 + 2 * 128 * (96 + 64) * 2 \
        + 3 * 64 * (96 + 64) * 2 + (4 + 6) * 8 + 32 + nkv64 * 4
    assert dkv.smem == 1024 + (128 + 3 * 64) * (96 + 64) * 2 \
        + 3 * 3 * 64 * 4 + 7 * 8 + 32 + nq64 * 4
    base = tops.flash_bwd_plan(b, h, kh, sq, skv, 64)
    assert (dq.grid, dq.heads, dkv.grid, dkv.cluster, dkv.heads) == (
        base[0].grid, base[0].heads, base[1].grid, base[1].cluster,
        base[1].heads)
    if h == kh:
        assert dkv.cluster == 1 and dkv.heads == ((0,),)
    for plan in tops.flash_bwd_plan(b, h, kh, 32768, 32768, 96, 64):
        assert plan.smem <= tops.SMEM_MAX
    # the partials of K3 (dK rows of 96 + 8, dV rows of 64 + 8 floats, 128
    # keys) fit over the ring of tiles they overlay
    assert 128 * (96 + 8) * 4 + 128 * (64 + 8) * 4 <= \
        (128 + 3 * 64) * (96 + 64) * 2
    with pytest.raises(ValueError, match="no ROADMAP item"):
        tops.flash_bwd_plan(b, h, kh, sq, skv, 112, 112)
