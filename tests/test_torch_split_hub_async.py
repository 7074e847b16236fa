"""The port's async many-client hub (``core/split.py``'s calibration state
and ``quantize_cotangent``, ``launch/schedules.py``'s ``arrival_mask``,
``init_hub_state``, ``build_async_update`` and ``async_tick_stream``,
``launch/split_hub.py::train_hub(mode="async")``, ``launch/e2e.py
--mode hub-async``) against the JAX reference, on the CPU, on reduced
llama3_2_3b in fp32.

The reference's async hub is mesh-free, so it runs in this process.  Its
states cross through ``repro_torch.bridge.from_jax_hub_state`` and its
parameters through ``from_jax_params``; batches come from each package's
``make_pipeline``, which give the same bytes.  The reference's pinned
async numbers in ``results/split_hub.json`` do not reproduce under the
JAX of this environment, so every comparison is with a live reference run
on the same state and batches.
"""
import dataclasses
import functools
import re

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core.quantizers import QuantConfig as JQC  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa: E402
from repro.launch import schedules as jsched  # noqa: E402
from repro.launch import split_hub as jhub  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro_torch.bridge import (from_jax_hub_state,  # noqa: E402
                                from_jax_params)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quantizers as tquant  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core.quantizers import QuantConfig as TQC  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.launch import e2e as te2e  # noqa: E402
from repro_torch.launch import schedules as tsched  # noqa: E402
from repro_torch.launch import split_hub as thub  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.loop import TrainState  # noqa: E402
from repro_torch.utils.tree import (tree_flatten_with_path,  # noqa: E402
                                    tree_map)

N, MB, SEQ, RATES = 3, 2, 16, (1, 2, 3)
N_TICKS = 6
# AdamW of the compared runs: eps 1e-6 as tests/test_torch_split_pipeline.py
# takes it; weight decay and the default clip (1.0, below every gradient
# norm here) on, so that the per-client decay mask and clip are held too
OPT = dict(lr=1e-3, eps=1e-6, weight_decay=0.1)
LOSS_RTOL = 1e-5   # one tick's loss, CE and wire error vs the reference
# parameters and moments after a tick: Adam's first steps are about
# lr g / (|g| + eps), so a gradient element of the order of eps turns the
# two frameworks' fp32 summation differences into a visible part of lr
# (5.9e-6 at most, measured: the embedding rows)
PARAM_ATOL = 1e-2 * OPT["lr"]
CALIB_RTOL = 1e-5  # EMA of fp32 means / stds / extrema, other sum order
# the 6-tick history, as the lockstep hub's 4-step histories: measured
# 1.8e-6 at most; the clients' weights differ by the PARAM_ATOL effect,
# which can move a code of the forward wire (on other batches an nf-4
# client's CE moved by 1.2e-4 at tick 2)
HIST_RTOL = 1e-4
LOCKSTEP_RTOL = 1e-3  # an all-arrive tick vs the lockstep hub step's loss


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread, as in
    tests/test_torch_split_hub.py: the suite runs a worker a core or so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _het(qc):
    """The reference's ``_hub_quants(3)``: rdfsq-2 / nf-4 / rdfsq-2."""
    r2 = qc(method="rdfsq", bits=2)
    return (r2, qc(method="nf", bits=4), r2)


def _hub(qc, hc, **kw):
    """The async hub of the comparisons, in the package of ``qc`` /
    ``hc``: the heterogeneous links, 2-bit cotangents, rates (1, 2, 3)."""
    return hc(n_clients=N, client_quants=_het(qc),
              bwd_quant=qc(method="rdfsq", bits=2), tick_rates=RATES, **kw)


def _cfgs():
    return (get_config("llama3_2_3b").reduced(),
            jget_config("llama3_2_3b").reduced())


def _batches(make, cfg, n_ticks, n=N, mb=MB, seq=SEQ):
    """``n_ticks`` (tokens, labels) pairs of (n, mb, seq) numpy arrays from
    a package's data pipeline, as the reference's ``dryrun_train_async``
    draws them."""
    pipe = make(cfg, n * mb, seq, seed=0)
    out = []
    for _ in range(n_ticks):
        b = next(pipe)
        out.append((np.asarray(b["tokens"]).reshape(n, mb, seq),
                    np.asarray(b["labels"]).reshape(n, mb, seq)))
    return out


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _leaves(tree):
    return [(path, leaf) for path, leaf in tree_flatten_with_path(tree)]


def _same(a, b):
    """Bit-identical trees of tensors."""
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _state_copy(state):
    s = state["server"]
    return dict(server=dict(params=_clone(s.params), opt=_clone(s.opt),
                            step=s.step.clone()),
                **{k: _clone(state[k])
                   for k in ("client_params", "client_opt", "calib")})


def _fresh_state(state):
    """A fresh port state (a bridged reference state, cloned: the ticks
    update in place)."""
    s = _state_copy(state)
    return dict(server=TrainState(**s["server"]),
                **{k: s[k] for k in ("client_params", "client_opt",
                                     "calib")})


def _client(tree, c):
    return {k: _client(v, c) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[c]


def _close(ours, theirs, atol, rtol=0.0, what=""):
    """Every leaf of the port's tree against the reference's (bridged)."""
    lo, lt = _leaves(ours), _leaves(theirs)
    assert [p for p, _ in lo] == [p for p, _ in lt], what
    for (path, a), (_, b) in zip(lo, lt):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what}{path}: {m}")


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The reference's hub state before any tick, after ticks 0 and 1 of
    one ``build_async_update`` (with their metrics) and its 6-tick
    ``train_hub(mode="async")``.  ``train_hub`` builds its own update with
    the same arguments; an ``lru_cache`` on ``build_async_update`` hands it
    the one already compiled."""
    _, jcfg = _cfgs()
    hub = _hub(JQC, jsplit.HubConfig)
    opt = JAdamW(**OPT)
    build = jsched.build_async_update
    cached = functools.lru_cache(maxsize=None)(build)
    jsched.build_async_update = cached
    try:
        state = jax.jit(lambda key: jsched.init_hub_state(
            key, jcfg, hub, opt))(jax.random.PRNGKey(0))
        out = dict(state0=from_jax_hub_state(state, "cpu"))
        update = cached(jcfg, hub, opt, MB, SEQ, lora_rank=0)
        batches = _batches(jmake_pipeline, jcfg, N_TICKS)
        masks = jsched.arrival_mask(RATES, 2).astype(np.float32)
        for t in range(2):
            state, metrics = update(state, jnp.asarray(batches[t][0]),
                                    jnp.asarray(batches[t][1]),
                                    jnp.asarray(masks[t]))
            out[t] = dict(state=from_jax_hub_state(state, "cpu"),
                          **{k: np.asarray(v) for k, v in metrics.items()})
        run = jhub.train_hub(jcfg, hub, opt, iter(batches), micro_batch=MB,
                             seq=SEQ, mode="async", n_ticks=N_TICKS)
        assert cached.cache_info().misses == 1, cached.cache_info()
    finally:
        jsched.build_async_update = build
    # the stage-stacked tree the state was drawn as (``init_hub_state``
    # draws ``init_hub_params``' tree from the same key)
    s0 = out["state0"]
    out["params0"] = dict(
        blocks=tree_map(lambda c, v: torch.cat([c, v[None]]),
                        s0["client_params"], s0["server"].params["blocks"]),
        **{k: s0["server"].params[k] for k in ("embed", "head",
                                              "final_norm")})
    out["train"] = dict(history=run["history"], masks=run["masks"],
                        quant_rel_err=run["quant_rel_err"],
                        state=from_jax_hub_state(run["state"], "cpu"))
    return out


# ---------------------------------------------------------------------------
# the wire pieces: the cotangent codec, calibration, arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,bits", [("rdfsq", 2), ("nf", 4),
                                         ("identity", 2)])
def test_quantize_cotangent(method, bits):
    """``tests/test_split_hub.py:118-136``: the forward is x, bit for bit;
    the cotangent is ``decode(encode(g))`` of the port's codec (the kernel
    codec's plain version here), exactly, and the reference's VJP within
    1e-6 (its flat-stream codec: the same values for RD-FSQ; for NF the
    kernel layout's fp16 block range, ROADMAP "The contract", within
    2e-3 x |g|max); identity passes the cotangent through untouched."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    g = rng.standard_normal((4, 8, 32)).astype(np.float32)
    q = TQC(method=method, bits=bits)
    xt = torch.tensor(x, requires_grad=True)
    y = tsplit.quantize_cotangent(q, xt)
    assert torch.equal(y, xt)
    (got,) = torch.autograd.grad(y, xt, torch.tensor(g))
    if method == "identity":
        assert torch.equal(got, torch.tensor(g))
        assert torch.equal(torch.autograd.grad(
            tsplit.quantize_cotangent(None, xt), xt, torch.tensor(g))[0],
            torch.tensor(g))
    else:
        assert torch.equal(got, tquant.decode(q, tquant.encode(
            q, torch.tensor(g))))
        assert not torch.equal(got, torch.tensor(g))
    jq = JQC(method=method, bits=bits)
    theirs = jax.jit(lambda v, ct: jax.vjp(
        lambda u: jsplit.quantize_cotangent(jq, u), v)[1](ct)[0])(
            jnp.asarray(x), jnp.asarray(g))
    atol = 2e-3 * np.abs(g).max() if method == "nf" else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=atol,
                               rtol=0)


def test_wire_calib_matches_reference():
    """``tests/test_split_hub.py:139-163`` on numpy draws: the first update
    adopts the batch statistics (population std), later ones blend; a 50x
    scale gap gives an isolation error above 0.5 and the same data below
    1e-6.  Every state equals the reference function's on the same arrays
    within CALIB_RTOL."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal(64).astype(np.float32)
    narrow, wide = 0.1 * z, 5.0 * z

    def both(calib, jcalib, x):
        ours = tsplit.update_wire_calib(calib, torch.tensor(x))
        theirs = jsplit.update_wire_calib(jcalib, jnp.asarray(x))
        _close(ours, from_jax_params(theirs, "cpu"), atol=1e-7,
               rtol=CALIB_RTOL)
        return ours, theirs

    c0, j0 = both(tsplit.init_wire_calib(), jsplit.init_wire_calib(), narrow)
    assert float(c0["count"]) == 1.0
    np.testing.assert_allclose(float(c0["std"]), np.std(narrow), rtol=1e-6)
    assert all(v.dtype == torch.float32 and v.shape == ()
               for v in c0.values())
    c0b, _ = both(c0, j0, 2.0 * narrow)
    assert float(c0["std"]) < float(c0b["std"]) < np.std(2.0 * narrow)
    assert float(c0b["count"]) == 2.0
    c1, j1 = both(tsplit.init_wire_calib(), jsplit.init_wire_calib(), wide)
    err = float(tsplit.calib_scale_error(c0, c1))
    assert err > 0.5, err
    np.testing.assert_allclose(
        err, float(jsplit.calib_scale_error(j0, j1)), rtol=1e-6)
    same = float(tsplit.calib_scale_error(c0, tsplit.update_wire_calib(
        tsplit.init_wire_calib(), torch.tensor(narrow))))
    assert same < 1e-6, same


def test_arrival_mask_and_tick_stream():
    """``arrival_mask((1, 2, 3), 6)`` as ``tests/test_split_hub.py:166-174``
    and the reference's; ``async_tick_stream`` yields the reference's
    ticks, float32 masks and batches in order."""
    m = tsched.arrival_mask(RATES, 6)
    assert m.shape == (6, 3) and m.dtype == bool
    np.testing.assert_array_equal(m[:, 0], [True] * 6)
    np.testing.assert_array_equal(m[:, 1], [1, 0, 1, 0, 1, 0])
    np.testing.assert_array_equal(m[:, 2], [1, 0, 0, 1, 0, 0])
    for rates, n in ((RATES, 6), ((2, 3), 7), ((1,), 3)):
        np.testing.assert_array_equal(tsched.arrival_mask(rates, n),
                                      jsched.arrival_mask(rates, n))
    items = list(range(10))
    ours = list(tsched.async_tick_stream(iter(items), (2, 3), 5))
    theirs = list(jsched.async_tick_stream(iter(items), (2, 3), 5))
    assert [(t, b) for t, _, b in ours] == [(t, b) for t, _, b in theirs]
    for (_, a, _), (_, b, _) in zip(ours, theirs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the async tick: isolation and gating
# ---------------------------------------------------------------------------

def _two_clients(client_scale=None, **opt):
    """``tests/test_split_hub.py:181-202`` on the port: a 2-client rdfsq-2
    hub, its state from ``init_hub_state`` (seed 0) with client c's blocks
    scaled by ``client_scale[c]``, and tokens from numpy."""
    cfg, _ = _cfgs()
    hub = tsplit.HubConfig(n_clients=2, quant=TQC(method="rdfsq", bits=2))
    opt = AdamWConfig(**opt)
    state = tsched.init_hub_state(cfg, hub, opt, device="cpu")
    if client_scale is not None:
        scale = torch.tensor(client_scale)
        for _, leaf in _leaves(state["client_params"]):
            leaf.mul_(scale.reshape((2,) + (1,) * (leaf.ndim - 1)))
    tok = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, MB, SEQ)).astype(np.int32)
    return cfg, hub, opt, state, _t(tok)


def _slice_client(state, c):
    """The reference's ``_slice_client`` (``tests/test_split_hub.py:205``):
    a solo (N = 1) state holding exactly client c of ``state``, the same
    server; copies, since ticks update a state in place."""
    s = _fresh_state(state)
    return dict(s, **{k: {kk: _client_slice(v, c) for kk, v in s[k].items()}
                      for k in ("client_params", "client_opt", "calib")})


def _client_slice(tree, c):
    return {k: _client_slice(v, c) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[c:c + 1].clone()


def test_per_client_calibration_isolation():
    """``tests/test_split_hub.py:213-252``: two clients whose blocks differ
    by 3x keep visibly different calibration, and each client's wire
    error and calibration inside the hub equal what it gets alone from the
    same weights (the reference's ``_slice_client`` construction), at lr 0
    over three ticks."""
    cfg, hub, opt, state, tok = _two_clients((1.0, 3.0), lr=0.0,
                                             weight_decay=0.0)
    solos = [_slice_client(state, c) for c in (0, 1)]
    update = tsched.build_async_update(cfg, hub, opt, MB, SEQ)
    for _ in range(3):
        state, metrics = update(state, tok, tok, [1.0, 1.0])
    calib = state["calib"]
    assert calib["count"].tolist() == [3.0, 3.0]
    c0, c1 = _client(calib, 0), _client(calib, 1)
    assert float(tsplit.calib_scale_error(c0, c1)) > 0.05
    hub_err = metrics["quant_rel_err"].numpy()

    solo_hub = tsplit.HubConfig(n_clients=1, quant=TQC(method="rdfsq",
                                                       bits=2))
    upd_solo = tsched.build_async_update(cfg, solo_hub, opt, MB, SEQ)
    for c, solo in enumerate(solos):
        for _ in range(3):
            solo, m_solo = upd_solo(solo, tok[c:c + 1], tok[c:c + 1], [1.0])
        np.testing.assert_allclose(hub_err[c],
                                   float(m_solo["quant_rel_err"][0]),
                                   rtol=1e-4)
        assert float(tsplit.calib_scale_error(
            _client(calib, c), _client(solo["calib"], 0))) < 1e-5


def test_non_arrivals_are_frozen():
    """``tests/test_split_hub.py:255-290``: with mask [1, 0] (lr 1e-2,
    weight decay 0.1), client 1's parameters, moments, step and
    calibration are bit-identical after the tick; client 0 moved and
    stepped once; the server stepped once."""
    cfg, hub, opt, state, tok = _two_clients(lr=1e-2, weight_decay=0.1)
    before = _state_copy(state)
    update = tsched.build_async_update(cfg, hub, opt, MB, SEQ)
    state, metrics = update(state, tok, tok, np.asarray([1.0, 0.0]))
    for key in ("client_params", "client_opt", "calib"):
        _same(_client(state[key], 1), _client(before[key], 1))
    assert state["calib"]["count"].tolist() == [1.0, 0.0]
    assert state["client_opt"]["step"].tolist() == [1, 0]
    moved = [not torch.equal(a, b) for (_, a), (_, b) in zip(
        _leaves(_client(state["client_params"], 0)),
        _leaves(_client(before["client_params"], 0)))]
    assert all(moved)
    assert int(state["server"].step) == 1
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(metrics["ces"][0]), rtol=1e-6)


def test_empty_tick_freezes_everything():
    """A tick with no arrival (rates (2, 3), tick 1): the server's
    parameters, moments and step stay bit-identical too, and so does every
    client; the loss is 0 and the grad norm 0."""
    cfg, _, opt, state, tok = _two_clients(lr=1e-2, weight_decay=0.1)
    hub = tsplit.HubConfig(n_clients=2, quant=TQC(method="rdfsq", bits=2),
                           bwd_quant=TQC(method="rdfsq", bits=2),
                           tick_rates=(2, 3))
    masks = tsched.arrival_mask(hub.resolve_tick_rates(), 2)
    assert masks[1].tolist() == [False, False]
    update = tsched.build_async_update(cfg, hub, opt, MB, SEQ)
    state, _ = update(state, tok, tok, masks[0])  # both arrive
    before = _state_copy(state)
    state, metrics = update(state, tok, tok, masks[1])
    after = _state_copy(state)
    _same(after, before)
    assert float(metrics["loss"]) == 0.0 and float(metrics["grad_norm"]) == 0
    assert after["server"]["step"].item() == 1


# ---------------------------------------------------------------------------
# against the reference's ticks and history
# ---------------------------------------------------------------------------

def test_one_tick_matches_reference(ref):
    """Ticks 0 (every client) and 1 (client 0 only) of the 3-client hub
    from the reference's state on its batches: loss, per-client CE, wire
    error and the server's grad norm within LOSS_RTOL; the server's and
    the clients' parameters and moments within PARAM_ATOL (ticks 0 and 1:
    client 0's second step reads its first step's clip scale, so a clip
    over the N-stacked tree would show); steps exact; calibration within
    CALIB_RTOL; clients 1 and 2 bit-identical across tick 1."""
    cfg, _ = _cfgs()
    hub = _hub(TQC, tsplit.HubConfig)
    update = tsched.build_async_update(cfg, hub, AdamWConfig(**OPT), MB,
                                       SEQ)
    state = _fresh_state(ref["state0"])
    batches = _batches(make_pipeline, cfg, 2)
    masks = tsched.arrival_mask(RATES, 2).astype(np.float32)
    for t in range(2):
        before = _state_copy(state)
        state, m = update(state, _t(batches[t][0]), _t(batches[t][1]),
                          masks[t])
        r = ref[t]
        for key in ("loss", "ces", "quant_rel_err", "grad_norm"):
            np.testing.assert_allclose(m[key].numpy(), r[key],
                                       rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_array_equal(m["mask"].numpy(), masks[t])
        rs = r["state"]
        _close(state["server"].params, rs["server"].params, PARAM_ATOL,
               what=f"tick {t} server ")
        _close(state["server"].opt, rs["server"].opt, PARAM_ATOL,
               what=f"tick {t} server moments ")
        assert int(state["server"].step) == int(rs["server"].step) == t + 1
        _close(state["client_params"], rs["client_params"], PARAM_ATOL,
               what=f"tick {t} clients ")
        for mom in ("m", "v"):
            _close(state["client_opt"][mom], rs["client_opt"][mom],
                   PARAM_ATOL, what=f"tick {t} client {mom} ")
        assert torch.equal(state["client_opt"]["step"],
                           rs["client_opt"]["step"])
        _close(state["calib"], rs["calib"], 1e-7, CALIB_RTOL)
        for c in np.flatnonzero(masks[t] == 0):
            for key in ("client_params", "client_opt", "calib"):
                _same(_client(state[key], c), _client(before[key], c))
    assert state["client_opt"]["step"].tolist() == [2, 1, 1]


def test_train_hub_async_history_matches_reference(ref):
    """``train_hub(mode="async")`` for N_TICKS ticks from the reference's
    parameters (its ``init_hub_params`` at the seed its ``init_hub_state``
    draws from) on the same batches: the loss history within HIST_RTOL, the
    masks, the client steps and calibration counts exact, the last wire
    errors within HIST_RTOL; the parameters it was given were updated in
    place."""
    cfg, _ = _cfgs()
    params = _clone(ref["params0"])
    out = thub.train_hub(cfg, _hub(TQC, tsplit.HubConfig),
                         AdamWConfig(**OPT),
                         iter(_batches(make_pipeline, cfg, N_TICKS)),
                         micro_batch=MB, seq=SEQ, mode="async",
                         n_ticks=N_TICKS, params=params)
    r = ref["train"]
    np.testing.assert_allclose(out["history"], r["history"], rtol=HIST_RTOL)
    assert len(out["history"]) == N_TICKS
    np.testing.assert_array_equal(np.stack(out["masks"]),
                                  np.stack(r["masks"]))
    np.testing.assert_allclose(out["quant_rel_err"], r["quant_rel_err"],
                               rtol=HIST_RTOL)
    state, rs = out["state"], r["state"]
    assert torch.equal(state["client_opt"]["step"], rs["client_opt"]["step"])
    assert torch.equal(state["calib"]["count"], rs["calib"]["count"])
    assert state["calib"]["count"].tolist() == [6.0, 3.0, 2.0]
    assert int(state["server"].step) == N_TICKS
    # the state's client halves and server half are views of ``params``
    assert state["client_params"]["attn"]["wq"].data_ptr() \
        == params["blocks"]["attn"]["wq"].data_ptr()
    assert not torch.equal(params["blocks"]["attn"]["wq"],
                           ref["params0"]["blocks"]["attn"]["wq"])


def test_reference_gate_on_the_port():
    """The reference's own gate (``test_async_hub_trains``,
    ``dryrun_train_async(n_ticks=18)``) on the port alone, from its own
    seed: 3 clients on rdfsq-2 / nf-4 / rdfsq-2 with 2-bit cotangents at
    rates (1, 2, 3), 4 x 32 tokens a client a tick, lr 5e-3: the mean of
    the last 3 ticks' losses below the first 3's, 33 arrivals, every
    calibration count its client's arrivals."""
    cfg, _ = _cfgs()
    n_ticks, mb, seq = 18, 4, 32
    out = thub.train_hub(
        cfg, _hub(TQC, tsplit.HubConfig),
        AdamWConfig(lr=5e-3, weight_decay=0.0),
        _batches(make_pipeline, cfg, n_ticks, mb=mb, seq=seq),
        micro_batch=mb, seq=seq, mode="async", n_ticks=n_ticks,
        device="cpu")
    hist = out["history"]
    assert all(np.isfinite(hist))
    assert np.mean(hist[-3:]) < np.mean(hist[:3]), hist
    assert int(sum(m.sum() for m in out["masks"])) == 33
    assert out["state"]["calib"]["count"].tolist() == [18.0, 9.0, 6.0]


def test_all_arrive_tick_gives_the_lockstep_loss():
    """A tick with every client arriving gives the loss and the per-client
    CE of the lockstep ``build_hub_grad_step`` at n_micro 1 on the same
    weights and batch, within LOCKSTEP_RTOL.  They are not equal: the STE
    roundtrip's forward is ``x + (x_hat - x)`` where the real wire decodes
    ``x_hat``, and the nf-4 link's kernel codec rounds the block range to
    fp16, the in-graph roundtrip not (measured: 1.1e-6 relative).
    ``clip_norm`` is large, so the tick updates with the gradient it
    computed."""
    cfg, _ = _cfgs()
    hub = _hub(TQC, tsplit.HubConfig)
    params = thub.init_hub_params(cfg, hub, seed=3, device="cpu")
    tok, lab = (_t(a) for a in _batches(make_pipeline, cfg, 1)[0])
    loss_l, per_client, _, _ = tsched.build_hub_grad_step(
        cfg, hub, 1, MB, SEQ)(params, tok[None], lab[None])
    opt = AdamWConfig(lr=1e-3, clip_norm=1e6)
    state = tsched.init_hub_state(cfg, hub, opt, params=params)
    state, m = tsched.build_async_update(cfg, hub, opt, MB, SEQ)(
        state, tok, lab, np.ones(N, np.float32))
    rel = abs(float(m["loss"]) - float(loss_l)) / abs(float(loss_l))
    print(f"all-arrive tick {float(m['loss']):.7f}, lockstep "
          f"{float(loss_l):.7f}: rel {rel:.3e}")
    assert rel < LOCKSTEP_RTOL, rel
    np.testing.assert_allclose(m["ces"].numpy(), per_client.numpy(),
                               rtol=LOCKSTEP_RTOL)
    assert int(state["server"].step) == 1
    assert state["client_opt"]["step"].tolist() == [1] * N


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_split_hub_entry_point_async(capsys):
    """``python -m repro_torch.launch.split_hub --mode async --device cpu
    --reduced``: a line per tick with its arrivals, the head and tail
    means, each client's last wire error and its calibration count equal
    to its arrivals; ``--bwd-method nf`` takes the NF-4 cotangent."""
    assert thub.main(["--device", "cpu", "--reduced", "--mode", "async",
                      "--ticks", "6", "--micro-batch", "2", "--seq", "32",
                      "--lr", "5e-3", "--bwd-bits", "4", "--bwd-method",
                      "nf"]) == 0
    out = capsys.readouterr().out
    ticks = re.findall(r"tick +(\d+) loss=([\d.]+) arrivals=\[([\d, ]*)\]",
                       out)
    assert [int(t) for t, _, _ in ticks] == list(range(6))
    assert all(np.isfinite(float(v)) for _, v, _ in ticks)
    assert [a for _, _, a in ticks] == ["0, 1, 2", "0", "0, 1", "0, 2",
                                        "0, 1", "0"]
    assert "cotangent nf-4bit" in out and "11 arrivals in 6 ticks" in out
    counts = re.findall(r"client (\d) \((\w+-\d)bit\): last wire rel err "
                        r"[\d.e+-]+, calibration count (\d+)", out)
    assert counts == [("0", "rdfsq-2", "6"), ("1", "nf-4", "3"),
                      ("2", "rdfsq-2", "2")]


def test_e2e_hub_async_mode(capsys, tmp_path):
    """``python -m repro_torch.launch.e2e --mode hub-async --device cpu``:
    the example's lines, arrivals per tick as the rates give them; then
    ``--mode lora`` (SplitLoRA on the async hub): a finite loss a tick and
    overall, the adapters below the frozen base's bytes by the printed
    factor, and the adapter checkpoint saved."""
    te2e.main(["--device", "cpu", "--mode", "hub-async", "--steps", "4",
               "--batch", "2", "--seq", "32", "--d-model", "128",
               "--layers", "2"])
    out = capsys.readouterr().out
    arrivals = re.findall(r"tick +\d+ loss=[\d.]+ arrivals=(\d)/3", out)
    assert arrivals == ["3", "1", "2", "2"]
    m = re.search(r"hub loss ([\d.]+) -> ([\d.]+) over 4 ticks; per-client "
                  r"wire rel err ([\d.]+), ([\d.]+), ([\d.]+)", out)
    assert m and all(np.isfinite(float(v)) for v in m.groups())
    assert "mode=hub-async" in out
    ckpt = tmp_path / "adapters.npz"
    te2e.main(["--device", "cpu", "--mode", "lora", "--steps", "4",
               "--batch", "2", "--seq", "32", "--d-model", "128",
               "--layers", "2", "--lora-rank", "2", "--ckpt", str(ckpt)])
    out = capsys.readouterr().out
    assert "mode=lora" in out
    ticks = re.findall(r"tick +\d+ loss=([\d.]+)", out)
    assert len(ticks) == 4 and all(np.isfinite(float(v)) for v in ticks)
    m = re.search(r"lora\(r=2\) loss ([\d.]+) -> ([\d.]+) over 4 ticks; "
                  r"adapters (\d+) KiB vs frozen base (\d+) KiB \((\d+)x\)",
                  out)
    assert m and all(np.isfinite(float(v)) for v in m.groups()), out
    ad_kib, base_kib, factor = (int(v) for v in m.groups()[2:])
    assert 0 < ad_kib < base_kib and factor == round(base_kib / ad_kib)
    assert ckpt.exists() and f"adapter checkpoint: {ckpt}" in out


def test_async_entry_needs_its_arguments():
    """``train_hub(mode="async")`` needs ``n_ticks``; the transport and the
    adaptive wire belong to the lockstep mode."""
    cfg, _ = _cfgs()
    hub = _hub(TQC, tsplit.HubConfig)
    opt = AdamWConfig()
    with pytest.raises(ValueError, match="n_ticks"):
        thub.train_hub(cfg, hub, opt, [], micro_batch=MB, seq=SEQ,
                       mode="async", device="cpu")
    for kw in (dict(transport=tsplit.Transport()),
               dict(wire_budget_bytes=64.0)):
        with pytest.raises(ValueError, match="lockstep"):
            thub.train_hub(cfg, hub, opt, [], micro_batch=MB, seq=SEQ,
                           mode="async", n_ticks=1, device="cpu", **kw)
    state = tsched.init_hub_state(cfg, hub, opt, device="cpu")
    with pytest.raises(ValueError, match="tokens"):
        tsched.build_async_update(cfg, hub, opt, MB, SEQ)(
            state, torch.zeros((N, MB, SEQ + 1), dtype=torch.int32),
            torch.zeros((N, MB, SEQ + 1), dtype=torch.int32), [1.0] * N)
    two = dataclasses.replace(hub, n_clients=2, client_quants=(),
                              tick_rates=())
    with pytest.raises(ValueError, match="stages"):
        tsched.init_hub_state(cfg, two, opt, params=thub.init_hub_params(
            cfg, hub, device="cpu"))
