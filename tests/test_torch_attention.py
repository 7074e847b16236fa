"""The port's attention (kernels K1, K2 / K3 and K8, and the layers around
them) against the JAX reference, on the CPU, in fp32."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import attention_ops as jops  # noqa: E402
from repro.kernels import attention_ref as jref  # noqa: E402
from repro.kernels import flash_kernel  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.kernels import attention_ref as tref  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402

ATOL = 1e-5
FAR = 2 ** 30


def _t(a):
    return torch.as_tensor(np.array(a))


def _qkv(b, sq, h, kh, d, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, kh, d)).astype(np.float32),
            rng.normal(size=(b, skv, kh, d)).astype(np.float32))


# (sq, skv, h, kh, window, kv_valid_len, chunk); padded tails: sq or skv
# not a multiple of the chunk
FLASH_CASES = [
    (48, 48, 4, 4, None, None, 16),   # causal
    (48, 48, 4, 2, None, None, 16),   # GQA
    (40, 40, 4, 2, None, None, 16),   # padded q / kv tail
    (32, 48, 4, 2, None, 24, 16),     # kv_valid_len + longer kv
    (48, 48, 4, 2, 12, None, 16),     # window
]


def _operands(sq, skv, h, kh, window, kv_valid_len, chunk, seed=0):
    """Pre-scaled, chunk-padded operands with sentinel positions, built as
    the reference's flash_attention builds them."""
    q, k, v = _qkv(1, sq, h, kh, 16, seed, skv)
    pad_q, pad_kv = (-sq) % chunk, (-skv) % chunk
    qs = np.pad(q * 16 ** -0.5, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
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


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_plain_matches_reference_kernel(case):
    """(out, m, l) of the plain K1 against the Pallas kernel in interpret
    mode and the jnp reference, on every row that sees a key.  A row that
    sees none (a padded q row) is 0 with l = 0 in the port; the reference
    leaves a block-size-dependent value there (ROADMAP queue F)."""
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case)
    bhsd = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa
    jo, jm, jl = flash_kernel.forward(
        jnp.asarray(bhsd(qs)), jnp.asarray(bhsd(k)), jnp.asarray(bhsd(v)),
        jnp.asarray(qpos.reshape(-1, 1)), jnp.asarray(kpos.reshape(1, -1)),
        window=window, block=chunk, interpret=True)
    to, tm, tl = tops.flash_forward(_t(bhsd(qs)), _t(bhsd(k)), _t(bhsd(v)),
                                    _t(qpos), _t(kpos), window=window)
    seen = np.asarray(tl)[..., 0] > 0
    assert seen[:, :, :sq].all() and not seen[:, :, sq:].any()
    np.testing.assert_allclose(to.numpy()[seen], np.asarray(jo)[seen],
                               atol=ATOL)
    np.testing.assert_allclose(tm.numpy()[seen], np.asarray(jm)[seen],
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy()[seen], np.asarray(jl)[seen],
                               rtol=ATOL)
    assert np.all(to.numpy()[~seen] == 0) and np.all(tl.numpy()[~seen] == 0)
    jr = jref.flash_reference(jnp.asarray(qs), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(qpos),
                              jnp.asarray(kpos), window, chunk)
    port = tops.flash(_t(qs), _t(k), _t(v), _t(qpos), _t(kpos), window)
    np.testing.assert_allclose(port.numpy()[:, :sq], np.asarray(jr)[:, :sq],
                               atol=ATOL)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    sq, skv, h, kh, window, kvl, chunk = case
    q, k, v = _qkv(2, sq, h, kh, 16, seed=1, skv=skv)
    kw = dict(window=window, kv_valid_len=kvl, q_chunk=chunk, kv_chunk=chunk)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), impl="pallas", **kw)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_gqa_forward_matches_reference():
    rng = np.random.default_rng(2)
    dm, h, kh, hd, s = 64, 4, 2, 16, 24
    p = {k: (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
         for k, shape in (("wq", (dm, h * hd)), ("wk", (dm, kh * hd)),
                          ("wv", (dm, kh * hd)), ("wo", (h * hd, dm)))}
    x = rng.normal(size=(2, s, dm)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, rope_theta=1e4,
              return_kv=True)
    jy, (jk, jv) = jattn.gqa_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos), **kw)
    ty, (tk, tv) = tattn.gqa_forward({k: _t(v) for k, v in p.items()},
                                     _t(x), positions=_t(pos), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def _bhsd(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_plain_matches_reference_kernels(case):
    """dq / dk / dv of the plain K2 / K3 against the Pallas backward_dq /
    backward_dkv in interpret mode and the jnp VJP of flash_reference,
    all fed the JAX forward's own (m, l) and di.  Rows that see no key
    (padded q rows) get a zero output gradient, as flash_attention gives
    them; there the reference's P is not 0 (attention_ref docstring)."""
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case)
    rng = np.random.default_rng(5)
    go = rng.normal(size=qs.shape).astype(np.float32)  # (B, S, H, D)
    go[:, sq:] = 0.0
    jq, jk, jv = (jnp.asarray(_bhsd(a)) for a in (qs, k, v))
    jqp, jkp = jnp.asarray(qpos.reshape(-1, 1)), jnp.asarray(
        kpos.reshape(1, -1))
    jo, jm, jl = flash_kernel.forward(jq, jk, jv, jqp, jkp, window=window,
                                      block=chunk, interpret=True)
    gob = _bhsd(go)
    di = np.sum(gob * np.asarray(jo), axis=-1, keepdims=True)
    kw = dict(window=window, block=chunk, interpret=True)
    jdq = flash_kernel.backward_dq(jq, jk, jv, jnp.asarray(gob), jm, jl,
                                   jnp.asarray(di), jqp, jkp, **kw)
    jdk, jdv = flash_kernel.backward_dkv(jq, jk, jv, jnp.asarray(gob), jm,
                                         jl, jnp.asarray(di), jqp, jkp, **kw)
    targs = [_t(_bhsd(a)) for a in (qs, k, v)] + [_t(gob), _t(jm), _t(jl),
                                                   _t(di), _t(qpos),
                                                   _t(kpos)]
    dq, dk, dv = tref.flash_backward_ref(*targs, window=window)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)
    # the wrappers run the same plain version on CPU tensors
    np.testing.assert_array_equal(
        tops.flash_backward_dq(*targs, window=window).numpy(), dq.numpy())
    wk, wv = tops.flash_backward_dkv(*targs, window=window)
    np.testing.assert_array_equal(wk.numpy(), dk.numpy())
    np.testing.assert_array_equal(wv.numpy(), dv.numpy())
    # the jnp custom VJP, in (B, S, H, D) layout
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_reference(
        a, b_, c, jnp.asarray(qpos), jnp.asarray(kpos), window, chunk),
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))
    rq, rk, rv = vjp(jnp.asarray(go))
    for port, ref in ((dq, rq), (dk, rk), (dv, rv)):
        np.testing.assert_allclose(_bhsd(port.numpy()), np.asarray(ref),
                                   atol=ATOL)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_grads_match_reference(case):
    """torch.autograd.grad through the port's flash_attention (the
    FlashAttention Function, K2 / K3's plain version on the CPU) against
    jax.grad through the reference's with its jnp custom VJP (the Pallas
    backward is held above)."""
    sq, skv, h, kh, window, kvl, chunk = case
    q, k, v = _qkv(2, sq, h, kh, 16, seed=3, skv=skv)
    w = np.random.default_rng(4).normal(size=(2, sq, h, 16)).astype(
        np.float32)
    kw = dict(window=window, kv_valid_len=kvl, q_chunk=chunk, kv_chunk=chunk)
    jg = jax.grad(lambda a, b_, c: jnp.sum(jattn.flash_attention(
        a, b_, c, impl="jnp", **kw) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, **kw)
    tg = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for port, ref in zip(tg, jg):
        assert port.shape == ref.shape and port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_function_gradcheck(window):
    """FlashAttention in fp64 on the CPU against finite differences, with
    GQA, a padded q row (qpos -2^30: it sees no key) and a padded key."""
    rng = np.random.default_rng(6)
    b, s, h, kh, d = 1, 8, 2, 1, 4
    qs, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float64,
                             requires_grad=True)
                for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    qpos = torch.tensor(list(range(s - 1)) + [-FAR], dtype=torch.int32)
    kpos = torch.tensor(list(range(s - 1)) + [FAR], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b_, c: tops.FlashAttention.apply(a, b_, c, qpos, kpos,
                                                   window),
        (qs, k, v), eps=1e-6, atol=1e-6)


def _paged_fixture():
    """The reference's own paged fixture: slot 0 has a -1 page, slot 2 is
    inactive (qpos = -1, no pages)."""
    rng = np.random.default_rng(0)
    p, pg, kh, g, d = 7, 8, 2, 2, 16
    pt = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1]], np.int32)
    qpos = np.array([12, 21, -1], np.int32)
    pos = np.full((p, pg), -1, np.int32)
    pos[1] = np.arange(pg)
    pos[2] = np.arange(pg, 2 * pg)
    pos[2, 5:] = -1
    for j in range(3):
        pos[3 + j] = np.arange(j * pg, (j + 1) * pg)
    qf = (rng.normal(size=(3, kh, g, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.normal(size=(p, pg, kh, d)).astype(np.float32)
    v = rng.normal(size=(p, pg, kh, d)).astype(np.float32)
    return qf, k, v, pos, pt, qpos


@pytest.mark.parametrize("window", [None, 6])
def test_decode_paged_plain_matches_reference(window):
    qf, k, v, pos, pt, qpos = _paged_fixture()
    jargs = [jnp.asarray(a) for a in (qf, k, v, pos, pt, qpos)]
    jk = jops.decode_paged_pallas(*jargs, window=window)  # interpret mode
    jr = jref.decode_attention_paged_ref(*jargs, window=window)
    out = tops.decode_paged(*[_t(a) for a in (qf, k, v, pos, pt, qpos)],
                            window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), atol=ATOL)
    assert np.all(out.numpy()[2] == 0.0)  # inactive slot: exact zero


def test_gather_pages_and_kpos_match_reference():
    _, k, _, pos, pt, _ = _paged_fixture()
    np.testing.assert_array_equal(
        tref.gather_pages(_t(k), _t(pt)).numpy(),
        np.asarray(jref.gather_pages(jnp.asarray(k), jnp.asarray(pt))))
    np.testing.assert_array_equal(
        tref.paged_kpos(_t(pos), _t(pt)).numpy(),
        np.asarray(jref.paged_kpos(jnp.asarray(pos), jnp.asarray(pt))))


def test_gqa_decode_paged_pool_writes_match_reference():
    """Several ticks with one inactive slot: outputs and every pool leaf,
    trash page included, match the reference's functional update."""
    rng = np.random.default_rng(3)
    s, h, kh, d, dm, pg, npp = 3, 4, 2, 16, 32, 4, 3
    p = {k: (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
         for k, shape in (("wq", (dm, h * d)), ("wk", (dm, kh * d)),
                          ("wv", (dm, kh * d)), ("wo", (h * d, dm)))}
    pt = np.array([[1, 2, 3], [4, 5, -1], [-1, -1, -1]], np.int32)
    jpool = jattn.init_paged_kv_pool(6, pg, kh, d, dtype=jnp.float32)
    tpool = tattn.init_paged_kv_pool(6, pg, kh, d, dtype=torch.float32,
                                     device="cpu")
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=d, rope_theta=1e4)
    for t in range(7):
        x = rng.normal(size=(s, 1, dm)).astype(np.float32)
        qpos = np.array([t, t if t < 6 else -1, -1], np.int32)
        jy, jpool = jattn.gqa_decode_paged(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jpool, qpos=jnp.asarray(qpos), page_table=jnp.asarray(pt), **kw)
        ty, tpool = tattn.gqa_decode_paged(
            {k: _t(v) for k, v in p.items()}, _t(x), tpool, qpos=_t(qpos),
            page_table=_t(pt), **kw)
        np.testing.assert_allclose(ty.numpy()[:2], np.asarray(jy)[:2],
                                   atol=ATOL)
        np.testing.assert_array_equal(tpool["pos"].numpy(),
                                      np.asarray(jpool["pos"]))
        for leaf in ("k", "v"):  # the trash page holds only garbage
            np.testing.assert_allclose(tpool[leaf].numpy()[1:],
                                       np.asarray(jpool[leaf])[1:],
                                       atol=ATOL)
    assert np.all(tpool["pos"].numpy()[0] == -1)


def test_int8_kv_cache_raises():
    with pytest.raises(NotImplementedError, match="K7/K9"):
        tattn.init_paged_kv_pool(4, 4, 2, 16, bits=8)
