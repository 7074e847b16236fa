"""The port's Mamba2 (SSD) layer (``repro_torch.models.layers.mamba2``)
against the reference's (``repro.models.layers.mamba2``) on the CPU, in
fp32, from the same numpy inputs and the reference's own parameters
(crossed with ``from_jax_params``): the chunked SSD with S a multiple of
the chunk and not, with and without an initial state, over several
chunks; the causal convolution with and without a cache; the forward with
its returned state, the one-token recurrence step by step, the gradient
against ``jax.grad``; the reference's own two Mamba2 tests mirrored on
the port; the port's initial values and cache.  No TPU kernel stands
behind the layer, so there is no kernel to hold here."""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models.layers import mamba2 as jm  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import mamba2 as tm  # noqa: E402
from repro_torch.models.transformer import leaf_makers  # noqa: E402

# fp32 on both sides, the same operations summed in another order: a
# single layer's outputs and states within ATOL of the reference's
# (relative to the largest |ref| where that passes 1); gradients, summed
# over the sequence and the chunks, within GRAD_ATOL
ATOL, GRAD_ATOL = 1e-5, 1e-4
D_MODEL, EXPAND, HD, DS = 32, 2, 16, 8
KW = dict(expand=EXPAND, headdim=HD, d_state=DS)


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


def _close(port, ref, atol=ATOL):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port.detach().float().numpy(), ref,
                               atol=atol * scale)


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    """The reference's mixer parameters and the port's copy of them."""
    jp = jm.init_mamba2_params(jax.random.PRNGKey(seed), D_MODEL, **KW)
    return jp, from_jax_params(jp, "cpu")


def _x(s, seed=1, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, D_MODEL)) * 0.5).astype(np.float32)


def _ssd_inputs(s, h=4, p=8, n=8, seed=3, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) - 2.0)).astype(
        np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    d_skip = np.ones((1, 1, h, 1), np.float32)
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a_log, b_in, c_in, d_skip, state


@pytest.mark.parametrize("s,chunk,init", [
    (64, 16, False),    # 4 whole chunks
    (50, 16, True),     # a padded last chunk, an initial state
    (10, 16, False),    # one padded chunk
    (96, 32, True),     # 3 whole chunks from a state
])
def test_ssd_chunked_matches_reference(s, chunk, init):
    """y and the final state of ``ssd_chunked`` (fp32 inside), S a
    multiple of the chunk or not, from zeros or a given state."""
    x, dt, a_log, b_in, c_in, d_skip, state = _ssd_inputs(s)
    args = (x, dt, a_log, b_in, c_in, d_skip)
    jy, js = jax.jit(functools.partial(jm.ssd_chunked, chunk=chunk))(
        *(jnp.asarray(a) for a in args),
        init_state=jnp.asarray(state) if init else None)
    ty, ts = tm.ssd_chunked(*(_t(a) for a in args), chunk=chunk,
                            init_state=_t(state) if init else None)
    assert ty.shape == x.shape and ts.shape == state.shape
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("cached", [False, True], ids=["zeros", "cache"])
def test_causal_conv_matches_reference(cached):
    """The depthwise causal convolution and the cache it returns (its last
    3 inputs), from zeros or from a given cache."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(tm.CONV_WIDTH, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    cache = rng.normal(size=(2, tm.CONV_WIDTH - 1, 12)).astype(np.float32)
    jo, jc = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(cache) if cached else None)
    to, tc = tm._causal_conv(_t(x), _t(w), _t(b),
                             _t(cache) if cached else None)
    _close(to, jo)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_split_proj_matches_reference():
    d_inner, nheads, _ = tm.dims(D_MODEL, EXPAND, HD, DS)
    zxbcdt = np.arange(2 * (2 * d_inner + 2 * DS + nheads),
                       dtype=np.float32).reshape(2, -1)
    for j, t in zip(jm._split_proj(jnp.asarray(zxbcdt), d_inner, DS,
                                   nheads),
                    tm._split_proj(_t(zxbcdt), d_inner, DS, nheads)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("s", [40, 17])
def test_mamba2_forward_and_state_match_reference(s):
    """The forward's output and, with ``return_state``, the SSM state and
    the convolution cache, over 3 chunks of 16 (S a multiple of the chunk
    and not)."""
    jp, tp = _params()
    x = _x(s)
    jo, jc = jax.jit(functools.partial(jm.mamba2_forward, chunk=16,
                                       return_state=True, **KW))(
        jp, jnp.asarray(x))
    to, tc = tm.mamba2_forward(tp, _t(x), chunk=16, return_state=True, **KW)
    _close(to, jo)
    assert set(tc) == set(jc) == {"state", "conv"}
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])
    np.testing.assert_array_equal(
        tm.mamba2_forward(tp, _t(x), chunk=16, **KW).numpy(), to.numpy())


def test_mamba2_decode_step_by_step_matches_reference():
    """``mamba2_decode`` over 6 tokens from the state a 9-token prefill
    left: each step's output and the carried state and cache."""
    jp, tp = _params()
    x = _x(15, seed=6)
    _, jc = jm.mamba2_forward(jp, jnp.asarray(x[:, :9]), chunk=8,
                              return_state=True, **KW)
    _, tc = tm.mamba2_forward(tp, _t(x[:, :9]), chunk=8, return_state=True,
                              **KW)
    step = jax.jit(functools.partial(jm.mamba2_decode, **KW))
    for t in range(9, 15):
        jy, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tm.mamba2_decode(tp, _t(x[:, t:t + 1]), tc, **KW)
        _close(ty, jy)
        _close(tc["state"], jc["state"])
        _close(tc["conv"], jc["conv"])


def test_mamba2_chunked_matches_decode_recurrence():
    """The reference's test_layers.py::test_mamba2_chunked_matches_decode_
    recurrence on the port: the chunked forward (chunks of 8) equals the
    step-by-step recurrence from a zero cache, at the reference's
    tolerance."""
    _, tp = _params()
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 24, D_MODEL)) * 0.5))
    full = tm.mamba2_forward(tp, x, chunk=8, **KW)
    cache = tm.init_mamba2_cache(2, D_MODEL, device="cpu", **KW)
    outs = []
    for t in range(24):
        y, cache = tm.mamba2_decode(tp, x[:, t:t + 1], cache, **KW)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_mamba2_chunk_size_invariant(chunk):
    """The reference's test_layers.py::test_mamba2_chunk_size_invariant on
    the port: chunks of 4 / 8 / 24 give the 24-chunk output within the
    reference's 1e-4."""
    _, tp = _params()
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 24, D_MODEL)) * 0.5))
    ref = tm.mamba2_forward(tp, x, chunk=24, **KW)
    out = tm.mamba2_forward(tp, x, chunk=chunk, **KW)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


def test_mamba2_forward_grad_matches_jax_grad():
    """The gradient of sum(forward(x) * g) in every parameter (A_log, D and
    dt_bias among them) and in x against ``jax.grad``, over 2 chunks and a
    padded third."""
    jp, tp = _params()
    x = _x(20, seed=8)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.mamba2_forward(p, xx, chunk=8, **KW)
                       * jnp.asarray(g))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = _t(x).requires_grad_()
    loss = (tm.mamba2_forward(tp, tx, chunk=8, **KW) * _t(g)).sum()
    grads = torch.autograd.grad(loss, [tx] + list(tp.values()))
    _close(grads[0], jgx, GRAD_ATOL)
    for (k, _), gr in zip(tp.items(), grads[1:]):
        assert torch.isfinite(gr).all(), k
        _close(gr, jgp[k], GRAD_ATOL)


def test_init_mamba2_params_have_the_reference_s_shapes_and_values():
    """A stack of 3 mixers drawn with ``leaf_makers`` in bf16: the
    reference's shapes; A_log, D and dt_bias in fp32 (A_log = log(linspace(
    1, 16, H)) and D ones, as the reference's; dt = softplus(dt_bias) in
    [0.001, 0.1]); conv_b zeros, norm_w ones; the scales of in_proj,
    conv_w and out_proj."""
    cfg = get_config("zamba2_2_7b").reduced()
    normal, const, gen, _ = leaf_makers(
        dataclasses.replace(cfg, param_dtype="bfloat16"), 0, "cpu")
    p = tm.init_mamba2_params(3, 64, normal, const, gen, **KW)
    jp = jm.init_mamba2_params(jax.random.PRNGKey(0), 64,
                               dtype=jnp.bfloat16, **KW)
    assert list(p) == list(jp)
    for k, v in p.items():
        assert tuple(v.shape) == (3,) + jp[k].shape, k
        assert (v.dtype == torch.float32) == (jp[k].dtype == jnp.float32), k
    np.testing.assert_allclose(p["A_log"].numpy(),
                               np.broadcast_to(np.asarray(jp["A_log"]),
                                               (3, jp["A_log"].shape[0])),
                               rtol=1e-6)
    assert bool((p["D"] == 1).all()) and bool((p["norm_w"] == 1).all())
    assert bool((p["conv_b"] == 0).all())
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 0.001 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    for k, scale in (("in_proj", 64 ** -0.5), ("conv_w", 0.1),
                     ("out_proj", (EXPAND * 64) ** -0.5)):
        assert abs(float(p[k].float().std()) / scale - 1) < 0.1, k


def test_init_mamba2_cache_matches_reference():
    """Zero state (B, H, P, N) in fp32 and conv (B, 3, conv_dim) in the
    compute dtype."""
    jc = jm.init_mamba2_cache(3, D_MODEL, dtype=jnp.bfloat16, **KW)
    tc = tm.init_mamba2_cache(3, D_MODEL, dtype=torch.bfloat16,
                              device="cpu", **KW)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16
    assert not any(bool(v.any()) for v in tc.values())
