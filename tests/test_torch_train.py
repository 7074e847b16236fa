"""The port's training slice against the JAX reference, on the CPU, in
fp32 unless stated: the compressor's gradients, one training step's loss
and gradients (remat off / on / two-level, grad accumulation), AdamW on
identical gradients, the data pipeline and checkpoints in both
directions, and a falling loss.  Parameters cross with
``from_jax_params``; inputs come from numpy seeds."""
import pytest

pytest.importorskip("jax")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_update as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jcosine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.losses import composite_loss as jloss  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import adamw_update as tadamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine as tcosine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

KEY = jax.random.PRNGKey(0)
# tinyllava.reduced(): 2 layers cut at 1, d 256, 16 image tokens of width
# 64, fp32 -- the same config in both packages
CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()
assert CFG.n_image_tokens == 16 and CFG.d_vision == 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deep(cfg):
    """Two-level remat needs >= 4 layers in a segment: 4 server layers,
    cut at 0."""
    return dataclasses.replace(cfg, n_layers=4, split=dataclasses.replace(
        cfg.split, cut_layer=0))


def _t(a):
    return torch.as_tensor(np.array(a))


def _leaves(tree):
    """'/'-joined path -> numpy leaf, for a JAX or a port tree."""
    if any(isinstance(x, torch.Tensor)
           for _, x in tree_flatten_with_path(tree)):
        return {"/".join(p): x.detach().float().numpy()
                for p, x in tree_flatten_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(x, np.float32)
            for p, x in flat}


def _batch(cfg, batch_size=4, seq=40, seed=0):
    return next(jpipeline(cfg, batch_size, seq, seed=seed))


# ---------------------------------------------------------------------------
# the compressor at the cut
# ---------------------------------------------------------------------------

def test_minmax_ties_share_gradient_equally():
    """amin / amax over clipped values tie; both frameworks split the
    gradient equally among the tied entries."""
    x = np.array([[3.0, 1.0, 3.0, -2.0, -2.0, -2.0]], np.float32)
    jmax = jax.grad(lambda a: jnp.max(a))(jnp.asarray(x))
    jmin = jax.grad(lambda a: jnp.min(a))(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    tmax, = torch.autograd.grad(tx.amax(), tx)
    tx = _t(x).requires_grad_()
    tmin, = torch.autograd.grad(tx.amin(), tx)
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), [[.5, 0, .5, 0, 0, 0]])


def test_compressor_grads_match_reference():
    """The gradient of compressor_roundtrip (STE + commitment loss) at 2
    bits with the 3-sigma clip active (outliers at both ends, so several
    clipped values tie for lo / hi), w.r.t. x and the codec.  Tolerance
    1e-5 of max |grad|: fp32 sums in another order."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    x[0, :3, :4] = 40.0
    x[1, :2, :5] = -40.0
    w = rng.normal(size=x.shape).astype(np.float32)
    d = x.shape[-1]
    codec = {"enc_w": np.eye(d) + 0.05 * rng.normal(size=(d, d)),
             "enc_b": 0.1 * rng.normal(size=(d,)),
             "dec_w": np.eye(d) + 0.05 * rng.normal(size=(d, d)),
             "dec_b": 0.1 * rng.normal(size=(d,))}
    codec = {k: v.astype(np.float32) for k, v in codec.items()}
    jcfg, tcfg = CFG.split, TCFG.split
    alpha = jcfg.quant.commit_alpha

    def jfn(xx, cp):
        y, c = jsplit.compressor_roundtrip(cp, jcfg, xx)
        return jnp.sum(y * w) + alpha * c

    jgx, jgc = jax.jit(jax.grad(jfn, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in codec.items()})
    tx = _t(x).requires_grad_()
    tc = {k: _t(v).requires_grad_() for k, v in codec.items()}
    y, c = tsplit.compressor_roundtrip(tc, tcfg, tx)
    grads = torch.autograd.grad((y * _t(w)).sum() + alpha * c,
                                [tx] + [tc[k] for k in codec])
    for g, ref, k in zip(grads, [jgx] + [jgc[k] for k in codec],
                         ["x"] + list(codec)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

def _jax_value_and_grad(jp, cfg, batch):
    alpha = cfg.split.quant.commit_alpha

    def loss_fn(params):
        logits, aux = jtf.forward(params, cfg, batch, rng=KEY)
        return jloss(logits, batch, aux, alpha)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)


def _assert_grads_close(tgrads, jgrads):
    """Every leaf within 1e-4 of max |leaf| plus 1e-6: fp32 through two
    layers, with sums in another order."""
    tg, jg = _leaves(tgrads), _leaves(jgrads)
    assert tg.keys() == jg.keys()
    for k in jg:
        tol = 1e-4 * float(np.abs(jg[k]).max()) + 1e-6
        np.testing.assert_allclose(tg[k], jg[k], atol=tol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _reference(deep: bool):
    """The reference's parameters, batch, metrics and gradients of one
    step (jax.value_and_grad of its loss), computed once per config and
    shared by the tests below: JAX's remat does not change them."""
    jcfg = _deep(CFG) if deep else CFG
    jp = jtf.init_params(KEY, jcfg)
    batch = _batch(jcfg)
    (_, jm), jg = _jax_value_and_grad(jp, jcfg, batch)
    return jp, batch, jm, jg


def _port_grads(deep: bool, **kw):
    jp, batch, _, _ = _reference(deep)
    grad_fn = tloop.make_grad_fn(_deep(TCFG) if deep else TCFG, **kw)
    return grad_fn(from_jax_params(jp, "cpu"),
                   tloop.batch_to(batch, torch.device("cpu")))


@pytest.mark.parametrize("remat,remat_group,deep", [
    (False, 0, False), (True, 0, False), (True, 2, True)],
    ids=["no-remat", "remat", "two-level"])
def test_train_step_grads_match_reference(remat, remat_group, deep):
    """loss / ce / commit and every gradient leaf of one step against
    jax.value_and_grad of the reference's loss, from the same bridged
    parameters and batch, under each of the port's remat policies."""
    _, _, jm, jg = _reference(deep)
    tg, tm = _port_grads(deep, remat=remat, remat_group=remat_group)
    for k in ("loss", "ce", "commit", "load_balance", "drop_fraction"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads_close(tg, jg)


@pytest.mark.parametrize("method,bits", [("nf", 4), ("fsq", 3),
                                         ("identity", 2)])
def test_train_step_other_codecs_match_reference(method, bits):
    """One step with the cut's compressor swapped, as ``launch/train.py
    --method`` swaps it (identity turns the split off): the codecs' plain
    roundtrips in-graph, loss and gradients against the reference's."""
    def swap(cfg, qcls):
        split = dataclasses.replace(cfg.split,
                                    quant=qcls(method=method, bits=bits),
                                    enabled=method != "identity")
        return dataclasses.replace(cfg, split=split)

    jcfg = swap(CFG, jsplit.QuantConfig)
    tcfg = swap(TCFG, tsplit.QuantConfig)
    jp, batch, _, _ = _reference(False)
    (_, jm), jg = _jax_value_and_grad(jp, jcfg, batch)
    tg, tm = tloop.make_grad_fn(tcfg)(from_jax_params(jp, "cpu"),
                                      tloop.batch_to(batch,
                                                     torch.device("cpu")))
    for k in ("loss", "ce", "commit"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads_close(tg, jg)


def test_grad_accumulation_matches_one_batch():
    """grad_accum=2 (positions broadcast, not split) against the reference's
    gradient of the whole batch: every microbatch holds the same number of
    answer labels, so the mean of the two means is the whole mean."""
    _, _, jm, jg = _reference(False)
    tg, tm = _port_grads(False, grad_accum=2)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_grads_close(tg, jg)
    assert all(g.dtype == torch.float32 for g in _leaves_t(tg))


def _leaves_t(tree):
    return [x for _, x in tree_flatten_with_path(tree)]


def test_train_step_and_bridged_state_match_reference():
    """A whole step (grads + warmup-cosine AdamW) from a JAX TrainState
    carried across with from_jax_params, optimizer moments included: the
    new parameters and moments agree with the reference's step."""
    opt = JAdamW(lr=1e-3)
    state = jloop.init_state(KEY, CFG, opt)
    # one reference step first, so the moments carried across are not 0
    jstep = jax.jit(jloop.make_train_step(CFG, opt, total_steps=10,
                                          warmup_steps=2))
    batch = _batch(CFG, seed=1)
    state, _ = jstep(state, _batch(CFG, seed=2), KEY)
    tstate = tloop.TrainState(
        params=from_jax_params(state.params, "cpu"),
        opt=from_jax_params(state.opt, "cpu"),
        step=_t(state.step))
    for k in ("m", "v"):
        np.testing.assert_array_equal(
            _leaves(tstate.opt[k])["server/seg0/ffn/w_up"],
            _leaves(state.opt[k])["server/seg0/ffn/w_up"])
    new_j, jm = jstep(state, batch, KEY)
    tstep = tloop.make_train_step(TCFG, AdamWConfig(lr=1e-3), total_steps=10,
                                  warmup_steps=2)
    new_t, tm = tstep(tstate, batch)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert int(new_t.step) == int(new_j.step) == 2
    # AdamW's update is sign-like where |g| >> eps: leaves whose gradient
    # is round-off noise may move by up to 2 lr between the frameworks
    lr = float(jm["lr"])
    tp, jp = _leaves(new_t.params), _leaves(new_j.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2 * lr + 1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# AdamW and the schedule on identical gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 6], ids=["step0", "step1",
                                                 "mid-cosine"])
def test_adamw_matches_reference_on_identical_grads(step):
    """Params, moments, grad_norm and lr from the same numpy params,
    moments and gradients, at schedule steps 0, 1 and mid-cosine (warmup
    2, total 10).  Clipping is active (grad norm > clip_norm).  Tolerance
    1e-6 relative: the same fp32 arithmetic."""
    rng = np.random.default_rng(7)
    shapes = {"a": {"w": (3, 5, 4), "ln": (3, 5)}, "b": (7,)}

    def draw(scale, positive=False):
        def one(shape):
            x = rng.normal(size=shape) * scale
            return np.abs(x).astype(np.float32) if positive \
                else x.astype(np.float32)
        return {"a": {k: one(s) for k, s in shapes["a"].items()},
                "b": one(shapes["b"])}

    params, grads = draw(1.0), draw(3.0)
    m, v = draw(0.1), draw(0.01, positive=True)
    jcfg, tcfg = JAdamW(lr=1e-3), AdamWConfig(lr=1e-3)
    jscale = jcosine(step, warmup_steps=2, total_steps=10)
    tscale = tcosine(step, warmup_steps=2, total_steps=10)
    np.testing.assert_allclose(float(tscale), float(jscale), rtol=1e-6)
    jt = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa
    tt = lambda tree: from_jax_params(tree, "cpu")  # noqa: E731
    jstate = dict(m=jt(m), v=jt(v), step=jnp.asarray(step, jnp.int32))
    tstate = dict(m=tt(m), v=tt(v), step=torch.tensor(step,
                                                       dtype=torch.int32))
    jp, jst, jmet = jadamw(jt(params), jt(grads), jstate, jcfg, jscale)
    tp, tst, tmet = tadamw(tt(params), tt(grads), tstate, tcfg, tscale)
    assert float(jmet["grad_norm"]) > jcfg.clip_norm
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == step + 1
    for port, ref in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
        a, b = _leaves(port), _leaves(ref)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modality", ["vlm", "text"])
def test_pipeline_batches_equal_reference(modality):
    jcfg = dataclasses.replace(CFG, modality=modality)
    tcfg = dataclasses.replace(TCFG, modality=modality)
    jit, tit = jpipeline(jcfg, 3, 40, seed=5), tpipeline(tcfg, 3, 40, seed=5)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == \
                tb[k].tobytes(), k


def _bf16_cfgs():
    return (dataclasses.replace(CFG, param_dtype="bfloat16"),
            dataclasses.replace(TCFG, param_dtype="bfloat16"))


def _assert_same_state(tstate, jstate):
    """Every leaf bit-equal, bf16 included (compared as raw bits)."""
    def bits(x):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                return x.view(torch.int16).numpy().view(np.uint16)
            return x.numpy()
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a

    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    jl = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                   for k in p): bits(x) for p, x in flat}
    tl = {}
    for name in ("params", "opt", "step"):
        for p, x in tree_flatten_with_path(getattr(tstate, name)):
            tl["/".join((name,) + p)] = bits(x)
    assert tl.keys() == jl.keys()
    for k in jl:
        assert tl[k].dtype == jl[k].dtype, k
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)


def test_jax_checkpoint_restores_into_port(tmp_path):
    jcfg, tcfg = _bf16_cfgs()
    opt = JAdamW()
    jstate = jloop.init_state(KEY, jcfg, opt)
    # non-trivial moments and step, so every leaf carries information
    jstate = dataclasses.replace(
        jstate, opt=dict(jstate.opt, m=jax.tree_util.tree_map(
            lambda p: p.astype(jnp.float32) * 0.5, jstate.params)),
        step=jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jstate)
    template = tloop.init_state(tcfg, AdamWConfig(), seed=3, device="cpu")
    restored = tckpt.restore(path, template)
    assert isinstance(restored, tloop.TrainState)
    _assert_same_state(restored, jstate)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jcfg, tcfg = _bf16_cfgs()
    tstate = tloop.init_state(tcfg, AdamWConfig(), seed=3, device="cpu")
    tstate = dataclasses.replace(tstate, step=torch.tensor(
        5, dtype=torch.int32))
    path = str(tmp_path / "port.npz")
    tckpt.save(path, tstate)
    template = jax.tree_util.tree_map(jnp.zeros_like,
                                      jloop.init_state(KEY, jcfg, JAdamW()))
    restored = jckpt.restore(path, template)
    _assert_same_state(tstate, restored)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_train_loop_lowers_ce():
    """30 steps of the port's train_loop on the reduced config lower CE,
    as tests/test_train_serve.py holds the reference's loop."""
    data = tpipeline(TCFG, 8, 32, seed=0)
    _, history = tloop.train_loop(TCFG, AdamWConfig(lr=3e-3), data,
                                  n_steps=30, log_every=29, device="cpu")
    first, last = history[0][1]["ce"], history[-1][1]["ce"]
    assert np.isfinite(last) and last < first * 0.8, (first, last)


def test_layer_forward_count_follows_remat_policy():
    """K1 launches per step: the forward plus one recompute per layer
    under single-level remat, two under two-level, none without."""
    x = torch.zeros((2, 8, TCFG.d_model))
    assert ttf.layer_forward_count(dataclasses.replace(TCFG, remat=False),
                                   x) == 2
    assert ttf.layer_forward_count(dataclasses.replace(TCFG, remat=True),
                                   x) == 4
    deep = dataclasses.replace(_deep(TCFG), n_layers=9, remat=True,
                               remat_group=4)
    assert ttf.layer_forward_count(deep, x) == 3 * 8 + 2 * 1


def test_launchers_run_on_cpu(tmp_path, capsys):
    from repro_torch.launch import e2e, train

    train.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                "40", "--log-every", "1", "--ckpt",
                str(tmp_path / "t.npz")])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "saved checkpoint" in out
    e2e.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
              "40", "--d-model", "128", "--layers", "1", "--ckpt",
              str(tmp_path / "e2e.npz")])
    out = capsys.readouterr().out
    assert "% reduction)" in out and (tmp_path / "e2e.npz").exists()


def test_train_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.init_state(TCFG, AdamWConfig())
    # the audio label layout is ported: labels_codes (B, K, S) against
    # logits (B, S, K, V)
    from repro_torch.train.losses import composite_loss, cross_entropy
    logits = torch.randn((2, 3, 2, 5), generator=torch.Generator()
                         .manual_seed(0))
    codes = torch.tensor([[[1, 2, 3], [4, 0, -100]],
                          [[0, 0, 1], [2, 3, 4]]])
    zero = torch.zeros(())
    _, m = composite_loss(logits, {"labels_codes": codes},
                          dict(commit=zero, load_balance=zero,
                               router_z=zero, drop_fraction=zero), 0.25)
    assert torch.equal(m["ce"], cross_entropy(logits, codes.transpose(1, 2)))
