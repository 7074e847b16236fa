"""The port's SplitLoRA hub (``core/split.py::grad_return_trip`` and
``WireLink.grad_trip`` / ``grad_wire_bytes``; ``launch/schedules.py``'s
``hub_wire_bytes``, ``build_hub_grad_step``, ``init_hub_state`` and
``build_async_update`` with ``lora_rank > 0``; ``train_hub(lora_rank=)`` in
both modes; ``core/split_stage.py::quantized_stage_blocks``) against the
JAX reference, on the CPU, on reduced llama3_2_3b in fp32.

The reference's lockstep hub is one SPMD program over a ``pod`` mesh axis,
so its runs (and its ``grad_return_trip``, a ``ppermute`` pair) go to one
subprocess with four fake CPU devices, on meshes (4, 1) and (2, 1); their
outputs cross as numpy arrays.  The async hub and the packed stage are
mesh-free and run in this process.  Parameters and states cross through
``repro_torch.bridge``.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import quantizers as jquant  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core import split_stage as jstage  # noqa: E402
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
from repro_torch.core import split_stage as tstage  # noqa: E402
from repro_torch.core.quantizers import QuantConfig as TQC  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.launch import schedules as tsched  # noqa: E402
from repro_torch.launch import split_hub as thub  # noqa: E402
from repro_torch.models import stack  # noqa: E402
from repro_torch.optim import (AdamWConfig, init_opt_state,  # noqa: E402
                               param_bytes)
from repro_torch.peft import adapter_bytes  # noqa: E402
from repro_torch.train.loop import TrainState  # noqa: E402
from repro_torch.utils.tree import (tree_flatten_with_path,  # noqa: E402
                                    tree_map)
from repro_torch.wq import PackedLinear  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the lockstep comparisons: tests/test_torch_split_hub.py's tolerances
LOSS_RTOL = 1e-4   # losses, per-client CE and 4-step histories
GRAD_COS = 0.9999  # per-leaf decoded adapter-gradient cosine
GRAD_NORM_RTOL = 1e-4  # per-leaf decoded adapter-gradient norm
N_MICRO, MB, SEQ, RANK = 2, 2, 16, 4  # the subprocess runs' shapes
# the history's AdamW: eps 1e-6 as tests/test_torch_split_pipeline.py
# takes it (Adam's eps turns a rounding-level gradient into a code flip)
TRAIN_LR, TRAIN_EPS = 1e-2, 1e-6
# the async comparisons: tests/test_torch_split_hub_async.py's tolerances,
# with weight decay on, so that the per-client decay is held too
N_ASYNC, RATES, RANK_ASYNC, N_TICKS = 2, (1, 2), 2, 6
OPT = dict(lr=1e-2, eps=1e-6, weight_decay=0.1)
TICK_RTOL = 1e-5   # one tick's loss, CE, wire error and grad norm
PARAM_ATOL = 1e-2 * OPT["lr"]  # adapters and moments after a tick
HIST_RTOL = 1e-4   # the 6-tick history
CE_GATE = 0.1  # packed vs dense stage CE, tests/test_wq.py:273-292


def _grad_quant(qc):
    """The reference's SplitLoRA gradient codec (``dryrun_lora``)."""
    return qc(method="rdfsq", bits=8, stats_axis="tensor")


def _het(qc):
    """The reference's ``_hub_quants(3)``: rdfsq-2 / nf-4 / rdfsq-2."""
    r2 = qc(method="rdfsq", bits=2)
    return (r2, qc(method="nf", bits=4), r2)


def _lock_hub(qc, hc, **kw):
    """The lockstep LoRA hub of the grad-step comparison."""
    return hc(n_clients=3, client_quants=_het(qc),
              grad_quant=_grad_quant(qc), **kw)


def _async_hub(qc, hc):
    """The async LoRA hub of ``tests/test_peft_lora.py:287`` (2-bit RD-FSQ
    links, the 8-bit gradient codec) with 2-bit cotangents and rates
    (1, 2)."""
    r2 = qc(method="rdfsq", bits=2)
    return hc(n_clients=N_ASYNC, quant=r2, bwd_quant=r2,
              grad_quant=_grad_quant(qc), tick_rates=RATES)


def _cfgs():
    return (get_config("llama3_2_3b").reduced(),
            jget_config("llama3_2_3b").reduced())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread, as in
    tests/test_torch_split_hub.py: the suite runs a worker a core or so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return tree_flatten_with_path(tree)


def _same(a, b, what=""):
    """Bit-identical trees of tensors."""
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, path)


def _close(ours, theirs, atol, rtol=0.0, what=""):
    lo, lt = _leaves(ours), _leaves(theirs)
    assert [p for p, _ in lo] == [p for p, _ in lt], what
    for (path, a), (_, b) in zip(lo, lt):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what}{path}: {m}")


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# the reference's lockstep runs, in a subprocess
# ---------------------------------------------------------------------------

REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import split as jsplit
from repro.core.quantizers import QuantConfig
from repro.core.quantizers import base as qbase
from repro.core.split import HubConfig
from repro.core.split_stage import stage_param_specs
from repro.launch import split_hub as sh
from repro.optim import AdamWConfig

N_MICRO, MB, SEQ, RANK = {n_micro}, {mb}, {seq}, {rank}
R2 = QuantConfig(method="rdfsq", bits=2)
HET = (R2, QuantConfig(method="nf", bits=4), R2)
GQ = QuantConfig(method="rdfsq", bits=8, stats_axis="tensor")
res = {{}}

# each run's thread takes its own codec backend, the explicit impl= rung
# of the reference's ladder: the run with an NF link the kernel codecs'
# layout (the port's), the others the flat-stream codecs
backend = threading.local()
resolve_impl = qbase.resolve_impl
qbase.resolve_impl = lambda impl=None: resolve_impl(
    impl or getattr(backend, "impl", None))

def mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("pod", "data"))

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

def batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size,
                       (N_MICRO, n, MB, SEQ)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((N_MICRO, n, MB, 1), -100, np.int32)], -1)
    return tok, lab

cfg = get_config("llama3_2_3b").reduced()
params = sh.init_hub_params(jax.random.PRNGKey(0), cfg,
                            HubConfig(n_clients=3), lora_rank=RANK)
# the grad step's adapters: B drawn nonzero, so that every leaf has a
# gradient (from B = 0, A's is zero)
rng = np.random.default_rng(3)
grad_params = dict(params, adapters=jax.tree_util.tree_map_with_path(
    lambda p, a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    if p[-1].key == "lora_b" else np.asarray(a), params["adapters"]))
flat(params, "params/")
flat(grad_params["adapters"], "grad_adapters/")
tok, lab = batch(cfg, 3, 2)
batches = [batch(cfg, 3, 10 + i) for i in range(4)]
m2, m4 = mesh(2), mesh(4)
# one stage's adapter-gradient tree for the trip, on pod 0 of (2, 1)
trip_in = jax.tree_util.tree_map(
    lambda a: (1e-3 * rng.standard_normal((2,) + a.shape[1:])).astype(
        np.float32), params["adapters"])
flat(trip_in, "trip_in/")

def grads():
    backend.impl = "pallas"
    with m4:
        loss, pc, g, wb = jax.jit(sh.build_hub_grad_step(
            cfg, m4, HubConfig(n_clients=3, client_quants=HET,
                               grad_quant=GQ), N_MICRO, MB, SEQ,
            lora_rank=RANK))(grad_params, tok, lab)
    return {{"grads/loss": loss, "grads/per_client": pc,
            "grads/wire": wb}}, (g, "grads/g/")

def train():
    # 4 AdamW steps of the lockstep LoRA hub from mesh-placed parameters,
    # where the steps leave them, so the update is traced once
    backend.impl = "jnp"
    placed = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: NamedSharding(m4, s),
        stage_param_specs(cfg, 4, 1, lora_rank=RANK)))
    with jax.set_mesh(m4):
        out = sh.train_hub(cfg, HubConfig(n_clients=3, quant=R2,
                                          grad_quant=GQ),
                           AdamWConfig(lr={lr}, eps={eps}, weight_decay=0.0),
                           iter(batches), micro_batch=MB, seq=SEQ,
                           mode="lockstep", mesh=m4, n_micro=N_MICRO,
                           params=placed, lora_rank=RANK)
    return {{"train/history": out["history"],
            "train/per_client": out["per_client"],
            "train/wire": out["wire_bytes_per_tick"]}}, None

def trip():
    # grad_return_trip on link 0 -> 1: pod 0's tree up and back
    backend.impl = "jnp"
    spec = jax.tree_util.tree_map(lambda _: P("pod"), trip_in)

    @partial(shard_map, mesh=m2, in_specs=(spec,), out_specs=spec,
             check_rep=False)
    def run(t):
        t0 = jax.tree_util.tree_map(lambda a: a[0], t)
        out = jsplit.grad_return_trip(GQ, t0, "pod", ((0, 1),))
        return jax.tree_util.tree_map(lambda a: a[None], out)

    with m2:
        out = jax.jit(run)(trip_in)
    return {{}}, (jax.tree_util.tree_map(lambda a: a[0], out), "trip_out/")

with ThreadPoolExecutor(3) as ex:
    jobs = [ex.submit(train), ex.submit(grads), ex.submit(trip)]
    for job in jobs:
        arrays, tree = job.result()
        res.update({{k: np.asarray(v) for k, v in arrays.items()}})
        if tree is not None:
            flat(*tree)
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module", autouse=True)
def _ref_run(tmp_path_factory):
    """Starts the reference's lockstep runs with the module's first test,
    so that the in-process tests overlap them."""
    path = tmp_path_factory.mktemp("split_hub_lora") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    code = textwrap.dedent(REF_SCRIPT.format(
        n_micro=N_MICRO, mb=MB, seq=SEQ, rank=RANK, lr=TRAIN_LR,
        eps=TRAIN_EPS))
    proc = subprocess.Popen([sys.executable, "-c", code, str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(_ref_run):
    proc, path = _ref_run
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as f:
        return dict(f)


def _unflatten(ref, prefix):
    tree = {}
    for key, arr in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _tree(ref, prefix):
    return from_jax_params(_unflatten(ref, prefix), "cpu")


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size,
                       (N_MICRO, n, MB, SEQ)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((N_MICRO, n, MB, 1), -100, np.int32)], -1)
    return torch.as_tensor(tok), torch.as_tensor(lab)


def _base(params):
    return {k: v for k, v in params.items() if k != "adapters"}


# ---------------------------------------------------------------------------
# the gradient return's bytes: a shape computation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("rank", [2, 4, 8])
def test_hub_wire_bytes_lora_matches_reference(rank, shards):
    """``hub_wire_bytes(lora_rank=)``: the per-link table, ``grad`` and
    ``grad_total`` included, equals the reference's."""
    cfg, jcfg = _cfgs()
    ours = tsched.hub_wire_bytes(cfg, _lock_hub(TQC, tsplit.HubConfig), 4,
                                 32, data_shards=shards, lora_rank=rank)
    theirs = jsched.hub_wire_bytes(jcfg, _lock_hub(JQC, jsplit.HubConfig),
                                   4, 32, data_shards=shards, lora_rank=rank)
    assert ours == theirs
    assert all(v["grad"] > 0 for v in ours["links"].values())
    assert ours["grad_total"] == 3 * ours["links"][(0, 3)]["grad"]


def test_hub_wire_bytes_lora_pins():
    """``BENCH_lora.json`` (3 clients, micro_batch 4, seq 32, the 8-bit
    tensor codec): 8 760 / 17 464 / 34 872 B a link at ranks 2 / 4 / 8,
    against 655 908 B for one stage's full parameter gradient, and the
    adapter payload under a quarter of it (``dryrun_lora``'s check,
    ``repro/launch/split_hub.py:587``).  ``stage_adapter_shapes`` draws no
    numbers: its leaves are ``meta`` tensors."""
    cfg, _ = _cfgs()
    hub = _lock_hub(TQC, tsplit.HubConfig)
    gq = _grad_quant(TQC)
    full = tsplit.tree_payload_bytes(gq, tstage.stage_blocks(
        thub.init_hub_params(cfg, hub, device="cpu"), 0))
    assert full == 655908
    for rank, pin in ((2, 8760), (4, 17464), (8, 34872)):
        table = tsched.hub_wire_bytes(cfg, hub, 4, 32, lora_rank=rank)
        assert [table["links"][(c, 3)]["grad"] for c in range(3)] == \
            [pin] * 3
        shapes = tsched.stage_adapter_shapes(cfg, rank)
        assert all(t.device.type == "meta" for _, t in _leaves(shapes))
        assert tsplit.tree_payload_bytes(gq, shapes) == pin < full / 4
    # full fine-tuning returns no gradient
    assert tsched.hub_wire_bytes(cfg, hub, 4, 32)["grad_total"] == 0


# ---------------------------------------------------------------------------
# the gradient return's values: grad_trip
# ---------------------------------------------------------------------------

def test_grad_trip_matches_reference(ref):
    """``WireLink.grad_trip`` on one stage's adapter-gradient tree: each
    leaf's codes equal the reference's encode, the decoded values are the
    reference's ``grad_return_trip``'s within one ulp of the leaf's
    largest value, and the transport
    counts exactly ``grad_wire_bytes`` each way, one payload a leaf; with
    no codec the raw tree goes up and back unchanged."""
    tree = tree_map(lambda a: a[0], _tree(ref, "trip_in/"))
    theirs = _tree(ref, "trip_out/")
    gq = _grad_quant(TQC)
    link = tsplit.WireLink(0, 1, TQC(), grad_quant=gq, client=0)
    transport = tsplit.Transport()
    ours = link.grad_trip(tree, transport)
    n_leaves = len(_leaves(tree))
    for (path, a), (_, b) in zip(_leaves(ours), _leaves(theirs)):
        # the jitted trip fuses decode's multiply-add (its eager decode
        # gives the port's bits): one ulp of the leaf's largest value
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=np.spacing(np.abs(b.numpy()).max()),
                                   err_msg=str(path))
    for (path, g), (_, j) in zip(_leaves(tree), _leaves(_unflatten(
            ref, "trip_in/"))):
        codes = tquant.encode(gq, g).data.numpy()
        np.testing.assert_array_equal(
            codes, np.asarray(jquant.encode(_grad_quant(JQC),
                                            jnp.asarray(j[0])).data))
    bytes_one_way = link.grad_wire_bytes(tree)
    assert bytes_one_way == tsplit.tree_payload_bytes(gq, tree) > 0
    assert dict(transport.bytes) == {(0, 1): bytes_one_way,
                                     (1, 0): bytes_one_way}
    assert dict(transport.payloads) == {(0, 1): n_leaves, (1, 0): n_leaves}
    raw = tsplit.WireLink(0, 1, TQC())
    transport = tsplit.Transport()
    _same(raw.grad_trip(tree, transport), tree)
    assert dict(transport.bytes) == {
        (0, 1): raw.grad_wire_bytes(tree), (1, 0): raw.grad_wire_bytes(tree)}
    assert raw.grad_wire_bytes(tree) == sum(
        t.numel() * 4 for _, t in _leaves(tree))


# ---------------------------------------------------------------------------
# the lockstep LoRA hub
# ---------------------------------------------------------------------------

def test_lora_grad_step_matches_reference(ref):
    """``build_hub_grad_step(lora_rank=4)`` over rdfsq-2 / nf-4 / rdfsq-2
    links and the 8-bit gradient return: the loss and each client's CE
    within LOSS_RTOL, the wire bytes exactly, every decoded adapter
    gradient leaf at cosine >= GRAD_COS with its norm within
    GRAD_NORM_RTOL.  Each client's slice is ``decode(encode(.))`` of the
    raw gradient and the server's the raw one (a run with no codec gives
    the raw tree); the transport counts ``n_micro`` shipments a link each
    way plus the gradient once up and once back."""
    cfg, _ = _cfgs()
    params = dict(_tree(ref, "params/"),
                  adapters=_tree(ref, "grad_adapters/"))
    tok, lab = _batch(cfg, 3, 2)
    hub = _lock_hub(TQC, tsplit.HubConfig)
    grad_step = tsched.build_hub_grad_step(cfg, hub, N_MICRO, MB, SEQ,
                                           lora_rank=RANK)
    loss, per_client, grads, wire = grad_step(params, tok, lab)
    np.testing.assert_allclose(float(loss), ref["grads/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(per_client.numpy(), ref["grads/per_client"],
                               rtol=LOSS_RTOL)
    assert wire == float(ref["grads/wire"])
    ours = dict(_leaves(grads))
    theirs = {tuple(k[len("grads/g/"):].split("/")): v
              for k, v in ref.items() if k.startswith("grads/g/")}
    assert set(ours) == set(theirs) and theirs
    cos = {k: _cos(ours[k].numpy(), theirs[k]) for k in theirs}
    assert min(cos.values()) >= GRAD_COS, cos
    for k in theirs:
        np.testing.assert_allclose(np.linalg.norm(ours[k].numpy()),
                                   np.linalg.norm(theirs[k]),
                                   rtol=GRAD_NORM_RTOL, err_msg=str(k))
    # the same step with no codec: the raw gradient
    _, _, raw, _ = tsched.build_hub_grad_step(
        cfg, dataclasses.replace(hub, grad_quant=None), N_MICRO, MB, SEQ,
        lora_rank=RANK)(params, tok, lab)
    gq = _grad_quant(TQC)
    for s, (got, want) in enumerate(zip(stack.tree_unbind(grads),
                                        stack.tree_unbind(raw))):
        if s < 3:
            want = tree_map(lambda g: tquant.decode(gq, tquant.encode(
                gq, g)), want)
        _same(got, want, f"stage {s}")
    table = thub.hub_wire_bytes(cfg, hub, MB, SEQ, lora_rank=RANK)
    n_leaves = len(_leaves(stack.tree_index(grads, 0)))
    expect, payloads = {}, {}
    for (src, dst), entry in table["links"].items():
        expect[(src, dst)] = entry["fwd"] * N_MICRO + entry["grad"]
        expect[(dst, src)] = entry["bwd"] * N_MICRO + entry["grad"]
        payloads[(src, dst)] = payloads[(dst, src)] = N_MICRO + n_leaves
    assert dict(grad_step.transport.bytes) == expect
    assert dict(grad_step.transport.payloads) == payloads


def test_train_hub_lora_matches_reference(ref):
    """Four AdamW steps of ``train_hub(lora_rank=4)`` (TRAIN_LR,
    TRAIN_EPS) over 2-bit links and the 8-bit gradient return: the loss
    history and the last step's per-client CE within LOSS_RTOL a step;
    every base leaf bit-identical (the same tensors, too); AdamW's moments
    mirror the adapters (m's bytes are the adapters' bytes, fp32 both), m
    + v the 557 056 B of ``BENCH_lora.json`` against full fine-tuning's
    23 087 104; the transport counts each link's shipments and one
    gradient return a step, each way."""
    cfg, _ = _cfgs()
    params = _tree(ref, "params/")
    base = {k: _clone(v) for k, v in _base(params).items()}
    hub = tsplit.HubConfig(n_clients=3, quant=TQC(method="rdfsq", bits=2),
                           grad_quant=_grad_quant(TQC))
    transport = tsplit.Transport()
    out = thub.train_hub(
        cfg, hub, AdamWConfig(lr=TRAIN_LR, eps=TRAIN_EPS, weight_decay=0.0),
        [_batch(cfg, 3, 10 + i) for i in range(4)], micro_batch=MB,
        seq=SEQ, n_micro=N_MICRO, params=params, lora_rank=RANK,
        transport=transport)
    np.testing.assert_allclose(out["history"], ref["train/history"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["per_client"], ref["train/per_client"],
                               rtol=LOSS_RTOL)
    assert out["wire_bytes_per_tick"] == float(ref["train/wire"])
    assert int(out["opt"]["step"]) == 4
    _same(_base(out["params"]), base)
    assert all(out["params"][k] is params[k] for k in base)
    ad = out["params"]["adapters"]
    assert [p for p, _ in _leaves(out["opt"]["m"])] == \
        [p for p, _ in _leaves(ad)]
    assert param_bytes(out["opt"]["m"]) == adapter_bytes(ad)
    assert param_bytes(out["opt"]["m"]) + param_bytes(out["opt"]["v"]) \
        == 557056
    full = init_opt_state(base, AdamWConfig())
    assert param_bytes(full["m"]) + param_bytes(full["v"]) == 23087104
    table = thub.hub_wire_bytes(cfg, hub, MB, SEQ, lora_rank=RANK)
    expect = {}
    for (src, dst), entry in table["links"].items():
        expect[(src, dst)] = 4 * (entry["fwd"] * N_MICRO + entry["grad"])
        expect[(dst, src)] = 4 * (entry["bwd"] * N_MICRO + entry["grad"])
    assert dict(transport.bytes) == expect


# ---------------------------------------------------------------------------
# the async LoRA hub: the reference in this process
# ---------------------------------------------------------------------------

def _async_batches(make, cfg, n_ticks):
    pipe = make(cfg, N_ASYNC * MB, SEQ, seed=0)
    out = []
    for _ in range(n_ticks):
        b = next(pipe)
        out.append((np.asarray(b["tokens"]).reshape(N_ASYNC, MB, SEQ),
                    np.asarray(b["labels"]).reshape(N_ASYNC, MB, SEQ)))
    return out


@pytest.fixture(scope="module")
def ref_async():
    """The reference's LoRA hub state before any tick, after ticks 0 and 1
    of one ``build_async_update(lora_rank=2)`` (with their metrics), and its
    6-tick ``train_hub(mode="async", lora_rank=2)``, whose update an
    ``lru_cache`` on ``build_async_update`` hands over compiled."""
    _, jcfg = _cfgs()
    hub = _async_hub(JQC, jsplit.HubConfig)
    opt = JAdamW(**OPT)
    build = jsched.build_async_update
    cached = functools.lru_cache(maxsize=None)(build)
    jsched.build_async_update = cached
    try:
        state = jax.jit(lambda key: jsched.init_hub_state(
            key, jcfg, hub, opt, lora_rank=RANK_ASYNC))(
                jax.random.PRNGKey(0))
        out = dict(state0=from_jax_hub_state(state, "cpu"))
        update = cached(jcfg, hub, opt, MB, SEQ, lora_rank=RANK_ASYNC)
        batches = _async_batches(jmake_pipeline, jcfg, N_TICKS)
        masks = jsched.arrival_mask(RATES, 2).astype(np.float32)
        for t in range(2):
            state, metrics = update(state, jnp.asarray(batches[t][0]),
                                    jnp.asarray(batches[t][1]),
                                    jnp.asarray(masks[t]))
            out[t] = dict(state=from_jax_hub_state(state, "cpu"),
                          **{k: np.asarray(v) for k, v in metrics.items()})
        run = jhub.train_hub(jcfg, hub, opt, iter(batches), micro_batch=MB,
                             seq=SEQ, mode="async", n_ticks=N_TICKS,
                             lora_rank=RANK_ASYNC)
        assert cached.cache_info().misses == 1, cached.cache_info()
    finally:
        jsched.build_async_update = build
    out["train"] = dict(history=run["history"],
                        state=from_jax_hub_state(run["state"], "cpu"))
    return out


def _fresh(state):
    """A port state from a bridged one, cloned (the ticks update in
    place)."""
    s = state["server"]
    return dict(server=TrainState(params=_clone(s.params), opt=_clone(s.opt),
                                  step=s.step.clone()),
                **{k: _clone(v) for k, v in state.items() if k != "server"})


def _stage_stacked(state):
    """The stage-stacked tree a LoRA hub state holds views of."""
    sp = state["server"].params

    def cat(clients, server):
        return tree_map(lambda c, v: torch.cat([c, v[None]]), clients,
                        server)

    return dict(blocks=cat(state["client_params"], sp["blocks"]),
                adapters=cat(state["client_adapters"], sp["adapters"]),
                **{k: sp[k] for k in ("embed", "head", "final_norm")})


def test_init_hub_state_lora_matches_reference(ref_async):
    """``init_hub_state(lora_rank=2)`` over the reference's stage-stacked
    parameters equals the reference's state, leaf for leaf: the frozen
    client blocks, the N-stacked ``client_adapters``, the server's params
    with ``"adapters"``, both optimizers sized by the adapter trees, the
    ``(N,)`` steps and the calibration.  The state holds views of the
    tree it was given."""
    cfg, _ = _cfgs()
    want = ref_async["state0"]
    params = _stage_stacked(_fresh(want))
    state = tsched.init_hub_state(cfg, _async_hub(TQC, tsplit.HubConfig),
                                  AdamWConfig(**OPT), params=params,
                                  lora_rank=RANK_ASYNC)
    assert sorted(state) == sorted(want) == [
        "calib", "client_adapters", "client_opt", "client_params", "server"]
    for k in ("client_params", "client_adapters", "client_opt", "calib"):
        _same(state[k], want[k], k)
    for k in ("params", "opt", "step"):
        _same(getattr(state["server"], k), getattr(want["server"], k), k)
    assert [p for p, _ in _leaves(state["server"].opt["m"])] == \
        [p for p, _ in _leaves(state["server"].params["adapters"])]
    leaf = state["client_adapters"]["attn"]["wq"]["lora_b"]
    assert leaf.data_ptr() == params["adapters"]["attn"]["wq"][
        "lora_b"].data_ptr()


def _tick(update, state, batches, t, masks):
    return update(state, torch.as_tensor(batches[t][0]),
                  torch.as_tensor(batches[t][1]), masks[t])


def test_async_lora_ticks_match_reference(ref_async):
    """Ticks 0 and 1 of ``build_async_update(lora_rank=2)`` (rates (1, 2):
    both clients arrive, then client 0 alone), each from the reference's
    state before it: the loss, each client's CE, wire error and the
    server's grad norm within TICK_RTOL; the adapters and moments within
    PARAM_ATOL, the steps and calibration counts exactly.  On tick 1
    client 1's adapters, moments, step and calibration are bit-identical
    to before, and every base leaf stays bit-identical.  Later ticks are
    held by the history: on tick 2 the 8-bit gradient codec takes another
    code for one element of client 0's gradient (a rounding-level
    difference of the two frameworks' sums at a code boundary), and Adam's
    normalised step moves that element by 0.05 lr (measured)."""
    cfg, _ = _cfgs()
    hub = _async_hub(TQC, tsplit.HubConfig)
    opt = AdamWConfig(**OPT)
    update = tsched.build_async_update(cfg, hub, opt, MB, SEQ,
                                       lora_rank=RANK_ASYNC)
    batches = _async_batches(make_pipeline, cfg, 2)
    masks = tsched.arrival_mask(RATES, 2).astype(np.float32)
    for t in range(2):
        state = _fresh(ref_async[t - 1]["state"] if t
                       else ref_async["state0"])
        base = (_clone(state["client_params"]),
                {k: _clone(v) for k, v in state["server"].params.items()
                 if k != "adapters"})
        before = _clone(dict(ad=state["client_adapters"],
                             m=state["client_opt"]["m"],
                             v=state["client_opt"]["v"],
                             calib=state["calib"]))
        step_before = state["client_opt"]["step"].clone()
        state, m = _tick(update, state, batches, t, masks)
        want = ref_async[t]
        for k in ("loss", "ces", "quant_rel_err", "grad_norm"):
            np.testing.assert_allclose(m[k].numpy(), want[k],
                                       rtol=TICK_RTOL, err_msg=f"{t} {k}")
        np.testing.assert_array_equal(m["mask"].numpy(), want["mask"])
        ws = want["state"]
        _close(state["client_adapters"], ws["client_adapters"], PARAM_ATOL,
               what=f"tick {t} client adapters ")
        _close(state["server"].params["adapters"],
               ws["server"].params["adapters"], PARAM_ATOL,
               what=f"tick {t} server adapters ")
        for k in ("m", "v"):
            _close(state["client_opt"][k], ws["client_opt"][k], PARAM_ATOL)
            _close(state["server"].opt[k], ws["server"].opt[k], PARAM_ATOL)
        assert torch.equal(state["client_opt"]["step"],
                           ws["client_opt"]["step"])
        assert int(state["server"].step) == int(ws["server"].step) == t + 1
        assert torch.equal(state["calib"]["count"], ws["calib"]["count"])
        if not masks[t][1]:
            _same(dict(ad=tree_map(lambda a: a[1], state["client_adapters"]),
                       m=tree_map(lambda a: a[1], state["client_opt"]["m"]),
                       v=tree_map(lambda a: a[1], state["client_opt"]["v"]),
                       calib=tree_map(lambda a: a[1], state["calib"])),
                  tree_map(lambda a: a[1], before), f"tick {t} client 1")
            assert state["client_opt"]["step"][1] == step_before[1]
        _same(state["client_params"], base[0])
        _same({k: v for k, v in state["server"].params.items()
               if k != "adapters"}, base[1])
    assert state["client_opt"]["step"].tolist() == [2, 1]


def test_train_hub_async_lora_matches_reference(ref_async):
    """``train_hub(mode="async", lora_rank=2)`` for 6 ticks from the
    reference's parameters: the history within HIST_RTOL; the state has
    ``client_adapters``; the client and server bases are bit-identical to
    before and some B factor moved (``tests/test_peft_lora.py:287``)."""
    cfg, _ = _cfgs()
    params = _stage_stacked(_fresh(ref_async["state0"]))
    base = {k: _clone(v) for k, v in _base(params).items()}
    out = thub.train_hub(
        cfg, _async_hub(TQC, tsplit.HubConfig), AdamWConfig(**OPT),
        _async_batches(make_pipeline, cfg, N_TICKS),
        micro_batch=MB, seq=SEQ, mode="async", n_ticks=N_TICKS,
        params=params, lora_rank=RANK_ASYNC)
    np.testing.assert_allclose(out["history"],
                               ref_async["train"]["history"],
                               rtol=HIST_RTOL)
    state = out["state"]
    assert "client_adapters" in state
    _same(_base(params), base)
    assert any(bool((t != 0).any()) for p, t in
               _leaves(state["client_adapters"]) if p[-1] == "lora_b")
    assert state["calib"]["count"].tolist() == [6.0, 3.0]


# ---------------------------------------------------------------------------
# the packed server stage
# ---------------------------------------------------------------------------

def _assert_same_store(jstore, tstore):
    assert isinstance(tstore, PackedLinear)
    for f in ("codes", "scales", "mins"):
        np.testing.assert_array_equal(getattr(tstore, f).numpy(),
                                      np.asarray(getattr(jstore, f)))
    assert (tstore.perm is None) == (jstore.perm is None)
    for f in ("bits", "group", "d_in", "d_out"):
        assert getattr(tstore, f) == getattr(jstore, f)


@pytest.mark.parametrize("gptq", [False, True])
def test_quantized_stage_blocks_matches_reference(gptq):
    """``quantized_stage_blocks(params, server, "int4", group=128)``: every
    site's codes, scales and mins bit-identical to the reference's (RTN,
    or GPTQ for the sites a Hessian covers), the same report with every
    packed size below its dense one, and the gate of
    ``tests/test_wq.py:273-292``: a batch's CE through the packed stage and
    the head within 0.1 of the dense stage's, and the reference's packed
    CE within 1e-4."""
    cfg, jcfg = _cfgs()
    jparams = jstage.init_stage_params(jax.random.PRNGKey(0), jcfg, 3,
                                       per_stage=jcfg.n_layers // 2)
    params = from_jax_params(jparams, "cpu")
    server = tstage.hub_programs(cfg, 2)[-1]
    hessians = None
    if gptq:
        rng = np.random.default_rng(4)
        hessians = {}
        for site in (("attn", "wq"), ("ffn", "w_down")):
            d_in = jparams["blocks"][site[0]][site[1]].shape[-2]
            x = rng.standard_normal((1, 64, d_in)).astype(np.float32)
            hessians[site] = np.einsum("lnd,lne->lde", x, x)
    qb, report = tstage.quantized_stage_blocks(params, server, "int4",
                                               group=128, hessians=hessians)
    jqb, jreport = jstage.quantized_stage_blocks(
        jparams, jstage.hub_programs(jcfg, 2)[-1], "int4", group=128,
        hessians=hessians)
    assert report == {k: tuple(int(x) for x in v)
                      for k, v in jreport.items()}
    assert report and all(p < d for d, p in report.values())
    for path, store in report.items():
        node_t, node_j = qb, jqb
        for k in path:
            node_t, node_j = node_t[k], node_j[k]
        _assert_same_store(node_j, node_t)
    # the index works as the program does
    qb2, _ = tstage.quantized_stage_blocks(params, server.index, "int4",
                                           hessians=hessians)
    for path in report:
        a, b = qb, qb2
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a.codes, b.codes)
    rng = np.random.default_rng(1)
    x = torch.tensor(0.4 * rng.standard_normal((2, 24, cfg.d_model)),
                     dtype=torch.float32)
    pos = torch.arange(24, dtype=torch.int32)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        dense = tstage.stage_blocks(params, server.index)
        ce_d = float(tstage.head_ce(cfg, params, tstage.run_blocks(
            cfg, dense, x, pos), labels))
        ce_q = float(tstage.head_ce(cfg, params, tstage.run_blocks(
            cfg, qb, x, pos), labels))
    assert abs(ce_d - ce_q) < CE_GATE, (ce_d, ce_q)
    jce_q = float(jstage.head_ce(jcfg, jparams, jstage.run_blocks(
        jcfg, jqb, jnp.asarray(x.numpy()), jnp.asarray(pos.numpy())),
        jnp.asarray(labels.numpy())))
    np.testing.assert_allclose(ce_q, jce_q, rtol=1e-4)
    # the trainable stack is untouched
    _same(dense, tstage.stage_blocks(from_jax_params(jparams, "cpu"),
                                     server.index))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_split_hub_entry_point_lora(capsys):
    """``python -m repro_torch.launch.split_hub --device cpu --reduced
    --lora-rank 4``: every link's counted bytes, both ways, equal its
    shipments' plus one gradient return a step; the adapter and moment
    bytes (m + v: two fp32 copies of the adapters)."""
    assert thub.main(["--device", "cpu", "--reduced", "--steps", "2",
                      "--n-micro", "2", "--micro-batch", "2", "--seq", "16",
                      "--lr", "3e-2", "--lora-rank", "4"]) == 0
    out = capsys.readouterr().out
    lines = re.findall(r"counted (\d+) B, hub_wire_bytes x 4 shipments = "
                       r"(\d+) B \+ grad x 2 steps = (\d+) B", out)
    assert len(lines) == 6 and all(a == c and int(b) < int(a)
                                   for a, b, c in lines), out
    m = re.search(r"adapters (\d+) parameters, (\d+) B; AdamW m \+ v "
                  r"(\d+) B", out)
    assert m and int(m.group(2)) == 4 * int(m.group(1)) \
        and int(m.group(3)) == 2 * int(m.group(2)), out
