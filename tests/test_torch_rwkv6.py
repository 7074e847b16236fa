"""rwkv6_7b in the port (``repro_torch.models.layers.rwkv6``, the rwkv6
block of ``repro_torch.models.transformer``) against the JAX reference, on
the CPU, from the same numpy inputs and the reference's own parameters
(crossed with ``from_jax_params``): the group norm in fp32 and bf16, the
token shift and projections, the chunked WKV against the reference's
chunked and recurrent forms (S a multiple of the chunk of 16 and not,
with and without an initial state) and its VJP against ``jax.vjp``, the
reference's two RWKV6 layer tests mirrored on the port, the layer's
forward and decode; then the model at ``rwkv6_7b.reduced()``: the config,
its segments and the full config's shapes, the tree and the bridge
(``decay_base`` and ``u`` fp32 in a bf16 tree), the forward's logits and
caches, prefill-then-decode against the forward, decode steps, greedy
``generate`` token for token, a training step's loss and gradients, the
paged pools' refusal and the launchers.  No TPU kernel stands behind the
layer, so there is no kernel to hold here."""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import QuantConfig, SplitConfig  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro.models.layers import rwkv6 as jr  # noqa: E402
from repro.serve import decode as jsd  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train.losses import composite_loss as jloss  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import norms as tnorms  # noqa: E402
from repro_torch.models.layers import rwkv6 as tr  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

# fp32 on both sides, the same operations summed in another order: the
# WKV within WKV_RTOL of the largest |ref| (1e-5 relative), its VJP within
# GRAD_RTOL; a layer's or the model's outputs and caches within ATOL of
# max(1, max |ref|), a decode step's logits within DECODE_ATOL; a training
# step's loss rtol 1e-5, each gradient leaf 1e-4 of its max |leaf| plus
# 1e-6 (as tests/test_torch_train.py)
WKV_RTOL, GRAD_RTOL = 1e-5, 1e-4
ATOL, DECODE_ATOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(0)
D_MODEL, HD = 64, 16
CACHE = 40


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


def _rel_close(t, j, rtol):
    """Within ``rtol`` of the largest |ref|: the relative tolerance of a
    whole tensor whose entries pass through zero."""
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().float().numpy(), j,
                               atol=rtol * float(np.abs(j).max()))


@functools.lru_cache(maxsize=None)
def _layer_params(seed=0):
    """The reference's time-mix parameters and the port's copy."""
    jp = jr.init_rwkv6_params(jax.random.PRNGKey(seed), D_MODEL, HD)
    return jp, from_jax_params(jp, "cpu")


def _x(s, seed=1, b=2, d=D_MODEL):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)


def _wkv_inputs(s, b=2, h=3, dk=8, seed=3):
    """r, k, v, a clamped log-decay (some steps at the clamp), u and a
    state, as numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, dk)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.normal(size=(b, s, h, dk)) * 1.5 - 1.0)
    log_w = np.clip(log_w, -jr.DECAY_CLAMP, 0.0).astype(np.float32)
    u = (rng.normal(size=(h, dk)) * 0.1).astype(np.float32)
    state = rng.normal(size=(b, h, dk, dk)).astype(np.float32)
    return r, k, v, log_w, u, state


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def test_constants_are_the_reference_s():
    assert (tr.DECAY_CLAMP, tr.MAA_RANK, tr.DECAY_RANK, tr.N_MIX) == \
        (jr.DECAY_CLAMP, jr.MAA_RANK, jr.DECAY_RANK, jr.N_MIX)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dtype):
    """The head norm over 8 groups of 12 in fp32 inside, cast back:
    within 1e-6 of max |ref| in fp32; in bf16 the same bits but for a
    rounding step where the fp32 values straddle a bf16 tie (at most one
    bf16 step, on at most 1% of the entries)."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 5, 96)) * 2 + 0.3).astype(np.float32)
    w = rng.normal(size=(96,)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j = jnorms.group_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                          jnp.asarray(bias, jdt), n_groups=8)
    t = tnorms.group_norm(_t(x).to(tdt), _t(w).to(tdt), _t(bias).to(tdt),
                          n_groups=8)
    assert t.dtype == tdt
    j32 = np.asarray(j, np.float32)
    if dtype == "float32":
        _rel_close(t, j32, 1e-6)
        return
    diff = np.abs(t.float().numpy() - j32)
    step = np.abs(j32) * 2.0 ** -7 + 1e-30
    assert (diff <= step).all()
    assert (diff > 0).mean() <= 0.01


def test_ddlerp_and_projections_match_reference():
    """The 5-way low-rank token shift (w, k, v, r, g) and the projections
    with the fp32 log-decay clamped to [-5, 0], over a shifted input."""
    jp, tp = _layer_params()
    x = _x(7)
    xp = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    for j, t in zip(jr._ddlerp(jp, jnp.asarray(x), jnp.asarray(xp)),
                    tr._ddlerp(tp, _t(x), _t(xp))):
        _close(t, j)
    jo = jr._projections(jp, jnp.asarray(x), jnp.asarray(xp), HD)
    to = tr._projections(tp, _t(x), _t(xp), HD)
    for j, t in zip(jo, to):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    assert to[-1].dtype == torch.float32
    assert float(to[-1].min()) >= -tr.DECAY_CLAMP
    assert float(to[-1].max()) <= 0.0


@pytest.mark.parametrize("s,init", [
    (48, False),   # 3 whole chunks
    (37, True),    # a padded last chunk, an initial state
    (10, False),   # one padded chunk
    (64, True),    # 4 whole chunks from a state
])
def test_wkv_chunked_matches_reference_chunked_and_recurrent(s, init):
    """y and the final state of the port's ``wkv_chunked`` (chunks of 16,
    fp32) against the reference's ``wkv_chunked`` and ``wkv_recurrent``,
    within 1e-5 of max |ref|."""
    r, k, v, log_w, u, state = _wkv_inputs(s)
    args = (r, k, v, log_w, u)
    st = jnp.asarray(state) if init else None
    jy, js = jax.jit(functools.partial(jr.wkv_chunked, chunk=16))(
        *(jnp.asarray(a) for a in args), init_state=st)
    ry, rs = jax.jit(jr.wkv_recurrent)(*(jnp.asarray(a) for a in args),
                                       init_state=st)
    ty, ts = tr.wkv_chunked(*(_t(a) for a in args), chunk=16,
                            init_state=_t(state) if init else None)
    assert ty.dtype == ts.dtype == torch.float32
    assert tuple(ty.shape) == r.shape and tuple(ts.shape) == state.shape
    for oracle_y, oracle_s in ((jy, js), (ry, rs)):
        _rel_close(ty, oracle_y, WKV_RTOL)
        _rel_close(ts, oracle_s, WKV_RTOL)


@pytest.mark.parametrize("init", [False, True], ids=["zeros", "state"])
def test_wkv_chunked_vjp_matches_jax_vjp(init):
    """The VJP of (y, final state) in r, k, v, log_w, u and the initial
    state against ``jax.vjp`` over 2 chunks and a padded third, within
    1e-4 of each gradient's max |ref|."""
    r, k, v, log_w, u, state = _wkv_inputs(40, seed=7)
    rng = np.random.default_rng(8)
    gy = rng.normal(size=r.shape).astype(np.float32)
    gs = rng.normal(size=state.shape).astype(np.float32)
    ins = (r, k, v, log_w, u) + ((state,) if init else ())

    def jf(*a):
        return jr.wkv_chunked(*a[:5], chunk=16,
                              init_state=a[5] if init else None)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in ins))
    jg = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    tin = [_t(a).requires_grad_() for a in ins]
    ty, ts = tr.wkv_chunked(*tin[:5], chunk=16,
                            init_state=tin[5] if init else None)
    tg = torch.autograd.grad((ty * _t(gy)).sum() + (ts * _t(gs)).sum(), tin)
    for t, j in zip(tg, jg):
        assert torch.isfinite(t).all()
        _rel_close(t, j, GRAD_RTOL)


def test_wkv_chunked_matches_recurrent():
    """The reference's test_layers.py::test_wkv_chunked_matches_recurrent on
    the port: its chunked WKV against its own recurrence, at the
    reference's tolerance (1e-3)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    b, s, h, dk = 2, 40, 2, 8
    r, k, v = (np.asarray(jax.random.normal(ks[i], (b, s, h, dk)))
               for i in range(3))
    log_w = -np.exp(np.asarray(jax.random.normal(ks[3], (b, s, h, dk)))
                    - 2.0)
    log_w = np.clip(log_w, -tr.DECAY_CLAMP, 0.0)
    u = np.asarray(jax.random.normal(ks[4], (h, dk))) * 0.1
    args = [_t(a) for a in (r, k, v, log_w, u)]
    y_c, s_c = tr.wkv_chunked(*args, chunk=16)
    y_r, s_r = tr.wkv_recurrent(*args)
    np.testing.assert_allclose(y_c.numpy(), y_r.numpy(), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(s_c.numpy(), s_r.numpy(), atol=1e-3,
                               rtol=1e-3)


def test_rwkv6_forward_matches_decode():
    """The reference's test_layers.py::test_rwkv6_forward_matches_decode on
    the port: the forward (chunks of 4) against 12 one-token decodes from
    a zero cache, at the reference's tolerance."""
    _, tp = _layer_params()
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 12, D_MODEL)) * 0.5))
    full = tr.rwkv6_forward(tp, x, head_dim=HD, chunk=4)
    cache = tr.init_rwkv6_cache(2, D_MODEL, HD, device="cpu")
    outs = []
    for t in range(12):
        y, cache = tr.rwkv6_decode(tp, x[:, t:t + 1], cache, head_dim=HD)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               atol=2e-3, rtol=1e-2)


def test_rwkv6_forward_and_decode_match_reference():
    """The forward over 21 positions (2 chunks) with its returned cache,
    then 4 decode steps from it: every output and cache leaf."""
    jp, tp = _layer_params()
    x = _x(25, seed=9)
    jo, jc = jax.jit(functools.partial(jr.rwkv6_forward, head_dim=HD,
                                       return_state=True))(
        jp, jnp.asarray(x[:, :21]))
    to, tc = tr.rwkv6_forward(tp, _t(x[:, :21]), head_dim=HD,
                              return_state=True)
    _close(to, jo)
    assert set(tc) == set(jc) == {"state", "x_last"}
    _close(tc["state"], jc["state"])
    np.testing.assert_array_equal(tc["x_last"].numpy(),
                                  np.asarray(jc["x_last"]))
    step = jax.jit(functools.partial(jr.rwkv6_decode, head_dim=HD))
    for t in range(21, 25):
        jy, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tr.rwkv6_decode(tp, _t(x[:, t:t + 1]), tc, head_dim=HD)
        _close(ty, jy, DECODE_ATOL)
        _close(tc["state"], jc["state"], DECODE_ATOL)


def test_init_rwkv6_params_have_the_reference_s_shapes_and_values():
    """A stack of 3 time mixes drawn in bf16: the reference's keys and
    shapes; decay_base (-4) and u in fp32, the rest bf16; mu 0.5, ln_w 1,
    ln_b 0; the scales of the projections."""
    cfg = dataclasses.replace(tget("rwkv6_7b").reduced(),
                              param_dtype="bfloat16")
    normal, const, _, _ = ttf.leaf_makers(cfg, 0, "cpu")
    p = tr.init_rwkv6_params(3, 128, normal, const, head_dim=32)
    jp = jr.init_rwkv6_params(KEY, 128, 32, dtype=jnp.bfloat16)
    assert list(p) == list(jp)
    for k, v in p.items():
        assert tuple(v.shape) == (3,) + jp[k].shape, k
        assert (v.dtype == torch.float32) == (jp[k].dtype == jnp.float32), k
    assert {k for k, v in p.items() if v.dtype == torch.float32} == \
        {"decay_base", "u"}
    assert bool((p["decay_base"] == -4).all())
    assert bool((p["mu_x"] == 0.5).all()) and bool((p["mu_mix"] == 0.5).all())
    assert bool((p["ln_w"] == 1).all()) and bool((p["ln_b"] == 0).all())
    for k, scale in (("wr", 128 ** -0.5), ("wo", 128 ** -0.5),
                     ("maa_w1", 0.01), ("decay_w2", 0.01), ("u", 0.1)):
        assert abs(float(p[k].float().std()) / scale - 1) < 0.1, k


def test_init_rwkv6_cache_matches_reference():
    """Zero state (B, H, K, K) in fp32 and x_last (B, 1, D) in the given
    dtype."""
    jc = jr.init_rwkv6_cache(3, D_MODEL, HD, dtype=jnp.bfloat16)
    tc = tr.init_rwkv6_cache(3, D_MODEL, HD, dtype=torch.bfloat16,
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32
    assert tc["x_last"].dtype == torch.bfloat16
    assert not any(bool(v.any()) for v in tc.values())


def test_cmix_forward_matches_reference():
    """The channel mix: relu^2 of the expansion under a sigmoid gate, over
    a shifted input."""
    jp = jtf.init_cmix_params(KEY, D_MODEL, 96)
    tp = from_jax_params(jp, "cpu")
    x = _x(6, seed=4)
    xp = _x(6, seed=5)
    _close(ttf.cmix_forward(tp, _t(x), _t(xp)),
           jtf.cmix_forward(jp, jnp.asarray(x), jnp.asarray(xp)))


# ---------------------------------------------------------------------------
# the model at reduced()
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(**upd):
    """(reference cfg, port cfg, reference params, port params)."""
    cfg = dataclasses.replace(get_config("rwkv6_7b").reduced(), **upd)
    tcfg = dataclasses.replace(tget("rwkv6_7b").reduced(), **upd)
    jp = jtf.init_params(KEY, cfg)
    return cfg, tcfg, jp, from_jax_params(jp, "cpu")


def _prompts(cfg, b=2, plen=21, seed=11):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, plen)).astype(np.int32)
    return dict(tokens=jnp.asarray(toks)), dict(tokens=_t(toks))


def _leaves(tree):
    """{path: fp32 numpy leaf} of a port tree or a reference tree."""
    if any(isinstance(x, torch.Tensor)
           for _, x in tree_flatten_with_path(tree)):
        return {"/".join(p): x.detach().float().numpy()
                for p, x in tree_flatten_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(x, np.float32)
            for p, x in flat}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _close_trees(t, j, atol=ATOL):
    tl, jl = _leaves(t), _leaves(j)
    assert tl.keys() == jl.keys()
    for k in jl:
        assert tl[k].shape == jl[k].shape, k
        np.testing.assert_allclose(
            tl[k], jl[k], atol=atol * max(1.0, float(np.abs(jl[k]).max())),
            err_msg=k)


@pytest.mark.parametrize("kind", ["full", "reduced"])
def test_config_and_segments_match_reference(kind):
    """``dataclasses.asdict``, the block pattern and the segments of the
    full and reduced configs equal the reference's; the alias names the
    same config."""
    ref, port = get_config("rwkv6_7b"), tget("rwkv6_7b")
    assert tget("rwkv6-7b") is port
    if kind == "reduced":
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.block_pattern() == ref.block_pattern()
    assert port.client_server_segments() == ref.client_server_segments()


def test_full_config_keeps_its_published_shapes():
    """32 rwkv6 layers in two segments of 16 around the cut, d 4 096 as 64
    heads of 64, d_ff 14 336, vocab 65 536, no attention."""
    cfg = tget("rwkv6_7b")
    assert cfg.block_pattern() == ("rwkv6",) * 32
    assert cfg.client_server_segments() == ((("rwkv6", 16),),
                                            (("rwkv6", 16),))
    assert (cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.attn_type) == (64, 64, 14336, 65536, "none")


def test_init_params_and_bridge_match_reference_tree():
    """The port's ``init_params`` gives the reference's tree key for key
    and shape for shape (ln1, ln2, tmix, cmix per layer), and
    ``from_jax_params`` carries the reference's tree across leaf for
    leaf."""
    _, tcfg, jp, tp = _setup()
    port = ttf.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(port) == _shapes(jp) == _shapes(tp)
    assert set(port["client"]["seg0"]) == {"ln1", "ln2", "tmix", "cmix"}
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])


def test_bf16_trees_keep_decay_base_and_u_fp32():
    """In bf16: the port's and the reference's trees have the same dtype
    leaf for leaf (decay_base and u fp32, the rest bf16), and so does the
    bridge's copy without ``dtype=``."""
    cfg = dataclasses.replace(get_config("rwkv6_7b").reduced(),
                              param_dtype="bfloat16")
    tcfg = dataclasses.replace(tget("rwkv6_7b").reduced(),
                               param_dtype="bfloat16")
    jp = jtf.init_params(KEY, cfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = {tuple(str(k.key) for k in p): str(x.dtype) for p, x in flat}
    for tree in (ttf.init_params(tcfg, seed=0, device="cpu"),
                 from_jax_params(jp, "cpu")):
        got = {p: str(x.dtype).removeprefix("torch.")
               for p, x in tree_flatten_with_path(tree)}
        assert got == want
    assert {p[-1] for p, d in want.items() if d == "float32"} == \
        {"decay_base", "u"}


def test_forward_logits_and_caches_match_reference():
    """Logits, the commitment loss and every collected cache ({tmix:
    {state, x_last}, cmix_last} a layer) of a prefill of 2 x 21 tokens
    (2 chunks, the second padded)."""
    cfg, tcfg, jp, tp = _setup()
    jb, tb = _prompts(cfg)
    jl, jaux, jc = jax.jit(functools.partial(jtf.forward, cfg=cfg,
                                             collect_cache=CACHE))(
        jp, batch=jb)
    tl, taux, tc = ttf.forward(tp, tcfg, tb, collect_cache=CACHE)
    _close(tl, jl)
    _close(taux["commit"], jaux["commit"])
    _close_trees(tc, jc)
    assert tc["client"]["seg0"]["tmix"]["state"].dtype == torch.float32


def test_prefill_then_decode_matches_forward():
    """The reference's test_train_serve.py::test_prefill_then_decode_
    matches_forward for rwkv6_7b on the port: the cut off, a prefill of 11
    tokens and one decode step against the full forward's last logits, at
    the reference's tolerance."""
    _, tcfg, _, _ = _setup()
    cfg = dataclasses.replace(tcfg, split=SplitConfig(
        quant=QuantConfig(method="identity"), learnable_codec=False,
        enabled=False))
    params = ttf.init_params(cfg, seed=0, device="cpu")
    tokens = _t(jax.random.randint(KEY, (2, 12), 0, cfg.vocab_size))
    full, _ = ttf.forward(params, cfg, dict(tokens=tokens))
    _, caches = tsd.prefill(params, cfg, dict(tokens=tokens[:, :11]),
                            cache_len=12)
    with torch.inference_mode():  # prefill's caches are inference tensors
        logits, _ = ttf.decode_step(params, cfg, caches,
                                    dict(tokens=tokens[:, 11:]),
                                    torch.full((2,), 11, dtype=torch.int32))
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-2, rtol=2e-2)


def test_decode_steps_match_reference():
    """Four one-token steps after the prefill: logits within DECODE_ATOL,
    then every cache (updated in place in the port)."""
    cfg, tcfg, jp, tp = _setup()
    jb, tb = _prompts(cfg)
    _, _, jc = jtf.forward(jp, cfg, jb, collect_cache=CACHE)
    _, _, tc = ttf.forward(tp, tcfg, tb, collect_cache=CACHE)
    step = jax.jit(functools.partial(jtf.decode_step, cfg=cfg))
    rng = np.random.default_rng(4)
    for i in range(4):
        toks = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        qpos = np.full((2,), 21 + i, np.int32)
        jl, jc = step(jp, caches=jc, batch=dict(tokens=jnp.asarray(toks)),
                      qpos=jnp.asarray(qpos))
        tl, tc2 = ttf.decode_step(tp, tcfg, tc, dict(tokens=_t(toks)),
                                  _t(qpos))
        assert tc2 is tc
        _close(tl, jl, DECODE_ATOL)
    _close_trees(tc, jc, DECODE_ATOL)


def test_init_caches_match_reference():
    """``init_caches``: the reference's nested tree, shapes and dtypes, all
    zeros."""
    cfg, tcfg, _, _ = _setup()
    jc = jtf.init_caches(cfg, 3, CACHE)
    tc = ttf.init_caches(tcfg, 3, CACHE, device="cpu")
    assert _shapes(tc) == _shapes(jc)
    for path, v in tree_flatten_with_path(tc):
        assert v.dtype == (torch.float32 if path[-1] == "state"
                           else torch.bfloat16), path
        assert not bool(v.any())


def test_generate_token_exact_vs_reference():
    """Greedy ``generate``, prefill included, 8 new tokens, token for token
    against the reference's."""
    cfg, tcfg, jp, tp = _setup()
    jb, tb = _prompts(cfg, b=3, seed=12)
    ref = np.asarray(jsd.generate(jp, cfg, jb, n_new=8, cache_len=CACHE))
    out = tsd.generate(tp, tcfg, tb, n_new=8, cache_len=CACHE).numpy()
    assert out.shape == (3, 8)
    np.testing.assert_array_equal(out, ref)


def test_train_step_loss_and_grads_match_reference():
    """One training step's composite loss and every gradient leaf against
    ``jax.grad`` on a batch of the data pipeline (2 x 24 positions), the
    2-bit cut in the graph."""
    cfg, tcfg, jp, tp = _setup()
    batch = next(jpipeline(cfg, 2, 24, seed=0))
    alpha = cfg.split.quant.commit_alpha

    def loss_fn(params):
        logits, aux = jtf.forward(params, cfg, batch, rng=KEY)
        return jloss(logits, batch, aux, alpha)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tg, tm = tloop.make_grad_fn(tcfg)(
        tp, tloop.batch_to(batch, torch.device("cpu")))
    for k in ("loss", "ce", "commit"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    tl, jl = _leaves(tg), _leaves(jg)
    assert tl.keys() == jl.keys()
    for k in jl:
        tol = 1e-4 * float(np.abs(jl[k]).max()) + 1e-6
        np.testing.assert_allclose(tl[k], jl[k], atol=tol, err_msg=k)
    assert float(np.abs(tl["client/seg0/tmix/u"]).max()) > 0


def test_layer_forward_count_is_zero():
    """No attention body runs in an rwkv6 block: K1 launches 0 times a
    training step, whatever the remat policy."""
    x = torch.empty((2, 1024, 4096), device="meta")
    for remat in (True, False):
        assert ttf.layer_forward_count(
            dataclasses.replace(tget("rwkv6_7b"), remat=remat), x) == 0


def test_engine_and_paged_pools_refuse_rwkv6_as_the_reference_does():
    """The paged pools have no rwkv6 form: both engines raise
    ``NotImplementedError`` with the same message, and so does the port's
    ``init_paged_caches``."""
    cfg, tcfg, jp, tp = _setup()
    kw = dict(n_slots=2, page_size=4, n_pages=9)
    with pytest.raises(NotImplementedError) as ref:
        JEngine(jp, cfg, **kw)
    with pytest.raises(NotImplementedError) as port:
        TEngine(tp, tcfg, device="cpu", **kw)
    assert str(port.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="rwkv6"):
        ttf.init_paged_caches(tcfg, 9, 4, device="cpu")


def test_launchers_run_at_reduced(capsys):
    """``launch.train`` and ``launch.serve_batched`` (prefill and the
    static loop) at ``reduced()`` on the CPU; ``--engine`` raises."""
    from repro_torch.launch import serve_batched, train

    train.main(["--device", "cpu", "--arch", "rwkv6_7b", "--steps", "2",
                "--batch", "2", "--seq", "20", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2
    serve_batched.main(["--device", "cpu", "--arch", "rwkv6-7b",
                        "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill(2x5)" in out and "decoded 3 tokens" in out
    with pytest.raises(NotImplementedError, match="rwkv6"):
        serve_batched.main(["--device", "cpu", "--arch", "rwkv6_7b",
                            "--engine", "--batch", "2", "--prompt-len", "5",
                            "--new-tokens", "3"])
