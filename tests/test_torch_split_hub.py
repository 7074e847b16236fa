"""The port's lockstep many-client hub (``core/split.py::HubConfig``,
``core/split_stage.py::hub_programs``, ``launch/schedules.py``'s hub
steps, ``launch/split_hub.py``) against the JAX reference, on the CPU, on
reduced llama3_2_3b in fp32.

The reference's hub is one SPMD program over a ``pod`` mesh axis, so it
runs in one subprocess with four fake CPU devices, on meshes (2, 1) and
(4, 1): one data shard, so each client's CE is one mean, as the port's
(the reference averages shard means with ``pmean``).  Its outputs cross as
numpy arrays, its parameters through ``repro_torch.bridge.from_jax_params``.
"""
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core import split_stage as jstage  # noqa: E402
from repro.core.quantizers import QuantConfig as JQC  # noqa: E402
from repro.launch import schedules as jsched  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core.quantizers import QuantConfig as TQC  # noqa: E402
from repro_torch.core.split_stage import (chain_programs,  # noqa: E402
                                          hub_programs)
from repro_torch.launch import schedules as tsched  # noqa: E402
from repro_torch.launch import split_hub as thub  # noqa: E402
from repro_torch.launch import split_pipeline as tsp  # noqa: E402
from repro_torch.utils.tree import (tree_flatten_with_path,  # noqa: E402
                                    tree_map)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4   # losses, per-client CE and 4-step histories vs the reference
GRAD_COS = 0.9999  # per-leaf gradient cosine vs the reference
GRAD_NORM_RTOL = 1e-4  # per-leaf gradient norm vs the reference
PARITY_RTOL = 3e-6  # hub(N = 1) vs the pipeline, the reference's own bound
N_MICRO, MB, SEQ = 2, 2, 16  # the subprocess runs' shapes
# the histories' AdamW (tests/test_torch_split_pipeline.py says why eps 1e-6)
TRAIN_LR, TRAIN_EPS = 1e-3, 1e-6
BUDGET = MB * SEQ * 256 * 2 / 8  # 2 bits of code a scalar, one shipment


def _het(qc):
    """The reference's ``_hub_quants(3)``: rdfsq-2 / nf-4 / rdfsq-2."""
    r2 = qc(method="rdfsq", bits=2)
    return (r2, qc(method="nf", bits=4), r2)


def _grouped(qc):
    """``dryrun_hub_grouped``'s clients: a uniform 3-bit grouped FSQ plan,
    the identity wire and a mixed-width RD-FSQ plan."""
    return (qc(method="fsq", group_widths=(3,) * 8), qc(method="identity"),
            qc(method="rdfsq", group_widths=(1, 2, 3, 8)))


def _hubs(qc, hc):
    """name -> the hub of that name, in the package of ``qc`` / ``hc``."""
    r2 = qc(method="rdfsq", bits=2)
    return {"one": hc(n_clients=1, quant=r2),
            "het": hc(n_clients=3, client_quants=_het(qc)),
            "het_bwd": hc(n_clients=3, client_quants=_het(qc), bwd_quant=r2),
            "grouped": hc(n_clients=3, client_quants=_grouped(qc)),
            "plain": hc(n_clients=3, quant=r2)}


# ---------------------------------------------------------------------------
# HubConfig, hub_programs, hub_wire_bytes: in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["one", "het", "het_bwd", "grouped"])
def test_hub_config_matches_reference(name):
    """Field by field; ``links()`` (one ``WireLink(src=c, dst=N,
    client=c)`` per client, the hub's cotangent and gradient codecs on
    each) and ``with_plans``."""
    ours = _hubs(TQC, tsplit.HubConfig)[name]
    ref = _hubs(JQC, jsplit.HubConfig)[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.server_stage == ref.server_stage == ours.n_clients
    assert [dataclasses.asdict(x) for x in ours.links()] == \
        [dataclasses.asdict(x) for x in ref.links()]
    assert [(x.src, x.dst, x.client) for x in ours.links()] == \
        [(c, ours.n_clients, c) for c in range(ours.n_clients)]
    assert ours.resolve_tick_rates() == ref.resolve_tick_rates()
    plans = tuple(((1, 2, 3, 2), (), (2,) * 4)[:ours.n_clients])
    assert dataclasses.asdict(ours.with_plans(plans)) \
        == dataclasses.asdict(ref.with_plans(plans))


def test_hub_config_validation():
    """The reference's errors (``tests/test_split_hub.py:107-116``), and
    ``with_plans`` with a plan count other than the clients'."""
    for hc, qc in ((tsplit.HubConfig, TQC), (jsplit.HubConfig, JQC)):
        with pytest.raises(ValueError, match="client_quants"):
            hc(n_clients=2, client_quants=(qc(),)).links()
        with pytest.raises(ValueError, match=">= 1"):
            hc(n_clients=2, tick_rates=(1, 0)).resolve_tick_rates()
        with pytest.raises(ValueError, match="tick_rates"):
            hc(n_clients=2, tick_rates=(1,)).resolve_tick_rates()
        assert hc(n_clients=3).resolve_tick_rates() == (1, 1, 1)
        assert hc(n_clients=2, tick_rates=(1, 3)).resolve_tick_rates() \
            == (1, 3)
        with pytest.raises(ValueError, match="plans"):
            hc(n_clients=2).with_plans(((2,),))


def test_hub_programs_match_reference():
    """``tests/test_split_hub.py:45-55``, and field by field against the
    reference's programs."""
    cfg, jcfg = (get_config("llama3_2_3b").reduced(),
                 jget_config("llama3_2_3b").reduced())
    chain = chain_programs(cfg, 2)
    assert [p.name for p in chain] == ["stage0/client", "stage1/server"]
    hub = hub_programs(cfg, 3)
    assert len(hub) == 4 and all(p.per_stage == 1 for p in hub)
    assert all(p.first and not p.last for p in hub[:3])
    assert hub[3].last and not hub[3].first and hub[3].index == 3
    assert [p.name for p in hub] == ["stage0/client", "stage1/client",
                                     "stage2/client", "stage3/server"]
    for n in (1, 3):
        assert [dataclasses.asdict(p) for p in hub_programs(cfg, n)] == \
            [dataclasses.asdict(p) for p in jstage.hub_programs(jcfg, n)]
    with pytest.raises(ValueError, match="half"):
        hub_programs(dataclasses.replace(cfg, n_layers=3), 2)


# (hub name, micro_batch, seq, data_shards)
WIRE_CASES = [("one", 2, 16, 1), ("het", 4, 16, 2), ("het", 2, 32, 1),
              ("het_bwd", 4, 16, 2), ("het_bwd", 2, 16, 1),
              ("grouped", 4, 16, 2), ("grouped", 2, 16, 1),
              ("plain", 8, 32, 2)]


@pytest.mark.parametrize("case", WIRE_CASES)
def test_hub_wire_bytes_matches_reference(case):
    """A shape computation: the per-link table equals the reference's."""
    name, mb, seq, shards = case
    ours = thub.hub_wire_bytes(get_config("llama3_2_3b").reduced(),
                               _hubs(TQC, tsplit.HubConfig)[name], mb, seq,
                               data_shards=shards)
    ref = jsched.hub_wire_bytes(jget_config("llama3_2_3b").reduced(),
                                _hubs(JQC, jsplit.HubConfig)[name], mb, seq,
                                data_shards=shards)
    assert ours == ref


def test_hub_wire_bytes_pins_the_results():
    """``results/split_hub.json`` (the reference's smoke: 3 clients,
    microbatches of 4 x 16, 2 data shards): ``hub.wire_links`` 4 112 /
    8 964 / 4 112 B and 4 482 B a tick; ``hub_grouped.wire_links`` 6 144 /
    32 768 / 7 232 B, the 3-bit link exactly 3/16 of the bf16 one."""
    cfg = get_config("llama3_2_3b").reduced()
    hubs = _hubs(TQC, tsplit.HubConfig)
    het = tsched.hub_wire_bytes(cfg, hubs["het"], 4, 16, data_shards=2)
    assert [het["links"][(c, 3)]["fwd"] for c in range(3)] == \
        [4112, 8964, 4112]
    assert het["fwd_tick"] == 4482
    grouped = tsched.hub_wire_bytes(cfg, hubs["grouped"], 4, 16,
                                    data_shards=2)["links"]
    assert [grouped[(c, 3)]["fwd"] for c in range(3)] == [6144, 32768, 7232]
    assert grouped[(0, 3)]["fwd"] / grouped[(1, 3)]["fwd"] == 3 / 16


def test_m9b3_parts_raise():
    """The argument errors of the hub's entry points: an unknown mode; a
    SplitLoRA rank below 0 (``train_hub`` in either mode,
    ``hub_wire_bytes``, ``init_hub_state``, the lockstep and async steps);
    a SplitLoRA state whose stage-stacked blocks and adapters are not
    N + 1 stages; SplitLoRA parameters without ``"adapters"``; an async
    update whose rank does not match its state; a gradient return over a
    permutation of more than one link."""
    cfg = get_config("llama3_2_3b").reduced()
    hub = _hubs(TQC, tsplit.HubConfig)["het"]
    opt = thub.AdamWConfig()
    with pytest.raises(ValueError, match="mode"):
        thub.train_hub(cfg, hub, opt, [], micro_batch=2, seq=16,
                       mode="sync")
    for call in (
            lambda: thub.train_hub(cfg, hub, opt, [], micro_batch=2,
                                   seq=16, lora_rank=-1),
            lambda: thub.train_hub(cfg, hub, opt, [], micro_batch=2,
                                   seq=16, mode="async", n_ticks=1,
                                   lora_rank=-1),
            lambda: thub.hub_wire_bytes(cfg, hub, 2, 16, lora_rank=-1),
            lambda: tsched.init_hub_state(cfg, hub, opt, device="cpu",
                                          lora_rank=-1),
            lambda: tsched.build_hub_step(cfg, hub, 2, 2, 16, lora_rank=-1),
            lambda: tsched.build_hub_grad_step(cfg, hub, 2, 2, 16,
                                               lora_rank=-1),
            lambda: tsched.build_async_update(cfg, hub, opt, 2, 16,
                                              lora_rank=-1)):
        with pytest.raises(ValueError, match="lora_rank"):
            call()
    two = dataclasses.replace(hub, n_clients=2, client_quants=())
    lora = thub.init_hub_params(cfg, hub, device="cpu", lora_rank=2)
    with pytest.raises(ValueError, match="stages"):
        tsched.init_hub_state(cfg, two, opt, params=lora, lora_rank=2)
    with pytest.raises(ValueError, match="stages"):
        tsched.init_hub_state(cfg, hub, opt, lora_rank=2, params=dict(
            lora, adapters=tree_map(lambda a: a[:3], lora["adapters"])))
    full = thub.init_hub_params(cfg, hub, device="cpu")
    tok = torch.zeros((1, 3, 2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="adapters"):
        tsched.init_hub_state(cfg, hub, opt, params=full, lora_rank=2)
    with pytest.raises(ValueError, match="adapters"):
        tsched.build_hub_grad_step(cfg, hub, 1, 2, 16, lora_rank=2)(
            full, tok, tok)
    with pytest.raises(ValueError, match="client_adapters"):
        tsched.build_async_update(cfg, hub, opt, 2, 16)(
            tsched.init_hub_state(cfg, hub, opt, params=lora, lora_rank=2),
            tok[0], tok[0], [1.0] * 3)
    link = tsplit.WireLink(0, 3, TQC(), grad_quant=TQC(), client=0)
    with pytest.raises(ValueError, match="perm"):
        tsplit.grad_return_trip(link.grad_quant, {}, tsplit.Transport(),
                                ((0, 3), (1, 3)))


# ---------------------------------------------------------------------------
# the reference's hub, in a subprocess
# ---------------------------------------------------------------------------

REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import threading
from concurrent.futures import ThreadPoolExecutor
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.core.quantizers import QuantConfig
from repro.core.quantizers import base as qbase
from repro.core.split import HubConfig
from repro.core.split_stage import stage_param_specs
from repro.launch import split_hub as sh
from repro.launch import split_pipeline as sp
from repro.optim import AdamWConfig

N_MICRO, MB, SEQ = {n_micro}, {mb}, {seq}
R2 = QuantConfig(method="rdfsq", bits=2)
HET = (R2, QuantConfig(method="nf", bits=4), R2)
GROUPED = (QuantConfig(method="fsq", group_widths=(3,) * 8),
           QuantConfig(method="identity"),
           QuantConfig(method="rdfsq", group_widths=(1, 2, 3, 8)))
res = {{}}

# The runs trace in parallel threads, each with its own codec backend: the
# runs with an NF link take the kernel codecs' layout (the port's), the
# others the flat-stream codecs.  A thread's backend is the explicit impl=
# rung of the reference's ladder (what REPRO_QUANT_IMPL sets process-wide).
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
params3 = sh.init_hub_params(jax.random.PRNGKey(0), cfg,
                             HubConfig(n_clients=3))
# the N = 1 hub's (= the 2-stage pipeline's) stages: client 0, the server
params1 = dict(params3, blocks=jax.tree_util.tree_map(
    lambda a: a[np.array([0, 3])], params3["blocks"]))
flat(params1, "one/params/")
flat(params3, "three/params/")
tok1, lab1 = batch(cfg, 1, 1)
tok3, lab3 = batch(cfg, 3, 2)
batches = [batch(cfg, 3, 10 + i) for i in range(4)]
m2, m4 = mesh(2), mesh(4)

def grads(name, bwd):
    backend.impl = "pallas"
    with m4:
        loss, pc, g, wb = jax.jit(sh.build_hub_grad_step(
            cfg, m4, HubConfig(n_clients=3, client_quants=HET,
                               bwd_quant=bwd), N_MICRO, MB, SEQ))(
                params3, tok3, lab3)
    return {{name + "/loss": loss, name + "/per_client": pc,
            name + "/wire": wb}}, (g, name + "/grads/")

def one():
    # hub(N = 1) and the 2-stage pipeline on the same weights
    backend.impl = "jnp"
    with m2:
        lp, _ = jax.jit(sp.build_pipeline_step(cfg, m2, R2, N_MICRO, MB,
                                               SEQ))(params1, tok1[:, 0],
                                                     lab1[:, 0])
        lh, pc, wb = jax.jit(sh.build_hub_step(
            cfg, m2, HubConfig(n_clients=1, quant=R2), N_MICRO, MB, SEQ))(
                params1, tok1, lab1)
    return {{"one/pipe_loss": lp, "one/loss": lh, "one/per_client": pc,
            "one/wire": wb}}, None

def grouped():
    backend.impl = "jnp"
    with m4:
        loss, pc, wb = jax.jit(sh.build_hub_step(
            cfg, m4, HubConfig(n_clients=3, client_quants=GROUPED), N_MICRO,
            MB, SEQ))(params3, tok3, lab3)
    return {{"grouped/loss": loss, "grouped/per_client": pc,
            "grouped/wire": wb}}, None

def train(name, **kw):
    # 4 AdamW steps of the lockstep hub, static or re-planned per client;
    # the parameters and the optimizer state start on the mesh, where the
    # steps leave them, so the update is traced once
    backend.impl = "jnp"
    log = []
    placed = jax.device_put(params3, jax.tree_util.tree_map(
        lambda s: NamedSharding(m4, s), stage_param_specs(cfg, 4, 1)))
    with jax.set_mesh(m4):
        out = sh.train_hub(cfg, HubConfig(n_clients=3, quant=R2),
                           AdamWConfig(lr={lr}, eps={eps}, weight_decay=0.0),
                           iter(batches), micro_batch=MB, seq=SEQ,
                           mode="lockstep", mesh=m4, n_micro=N_MICRO,
                           params=placed, plan_log=log, **kw)
    return {{name + "/history": out["history"],
            name + "/per_client": out["per_client"],
            name + "/wire": out["wire_bytes_per_tick"],
            name + "/plan_steps": np.asarray([s for s, _ in log], np.int64),
            name + "/plans": np.asarray([p for _, p in log], np.int64)}}, None

with ThreadPoolExecutor(6) as ex:
    jobs = [ex.submit(train, "adaptive", wire_budget_bytes={budget},
                      plan_groups=8),
            ex.submit(train, "train"), ex.submit(grads, "het", None),
            ex.submit(grads, "het_bwd", R2), ex.submit(one),
            ex.submit(grouped)]
    for job in jobs:
        arrays, tree = job.result()
        res.update({{k: np.asarray(v) for k, v in arrays.items()}})
        if tree is not None:
            flat(*tree)
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine (the entry point's 4 CPU steps: 3 s alone, 21 s on one thread
    and 140 s on eight beside five busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _ref_run(tmp_path_factory):
    """Starts the reference's runs (about a minute on the CPU) with the
    module's first test, so that the in-process tests overlap them."""
    path = tmp_path_factory.mktemp("split_hub") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    code = textwrap.dedent(REF_SCRIPT.format(
        n_micro=N_MICRO, mb=MB, seq=SEQ, budget=BUDGET, lr=TRAIN_LR,
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
    """The reference's losses, per-client CE, gradients, wire bytes and
    4-step histories."""
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


def _params(ref, name):
    prefix = "one/params/" if name == "one" else "three/params/"
    return from_jax_params(_unflatten(ref, prefix), "cpu")


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size,
                       (N_MICRO, n, MB, SEQ)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((N_MICRO, n, MB, 1), -100, np.int32)], -1)
    return torch.as_tensor(tok), torch.as_tensor(lab)


def _cfg():
    return get_config("llama3_2_3b").reduced()


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_hub_one_client_is_the_pipeline(ref):
    """hub(N = 1) gives the 2-stage pipeline's loss, in the reference
    (its own bound, 3e-6) and in the port (the same operations in the same
    order: equal), and the port's loss is the reference's within
    LOSS_RTOL.  The port's gradients of the two agree too."""
    cfg = _cfg()
    r2 = TQC(method="rdfsq", bits=2)
    assert abs(float(ref["one/loss"]) - float(ref["one/pipe_loss"])) \
        <= PARITY_RTOL * abs(float(ref["one/pipe_loss"]))
    params = _params(ref, "one")
    tok, lab = _batch(cfg, 1, 1)
    hub = tsplit.HubConfig(n_clients=1, quant=r2)
    loss, per_client, wire = tsched.build_hub_step(
        cfg, hub, N_MICRO, MB, SEQ)(params, tok, lab)
    pipe, _ = tsp.build_pipeline_step(cfg, r2, N_MICRO, MB, SEQ)(
        params, tok[:, 0], lab[:, 0])
    assert abs(float(loss) - float(pipe)) <= PARITY_RTOL * abs(float(pipe))
    np.testing.assert_allclose(float(loss), ref["one/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(per_client.detach().numpy(),
                               ref["one/per_client"], rtol=LOSS_RTOL)
    assert wire == float(ref["one/wire"])
    _, _, hub_grads, _ = tsched.build_hub_grad_step(
        cfg, hub, N_MICRO, MB, SEQ)(params, tok, lab)
    _, pipe_grads, _ = tsp.build_pipeline_grad_step(
        cfg, r2, None, N_MICRO, MB, SEQ)(params, tok[:, 0], lab[:, 0])
    for (path, a), (_, b) in zip(tree_flatten_with_path(hub_grads),
                                 tree_flatten_with_path(pipe_grads)):
        torch.testing.assert_close(a, b, rtol=PARITY_RTOL, atol=0,
                                   msg=lambda m: f"{path}: {m}")


@pytest.mark.parametrize("name", ["het", "grouped"])
def test_hub_loss_matches_reference(ref, name):
    """``build_hub_step``: the loss and each client's CE within LOSS_RTOL,
    the per-tick wire bytes exactly; the transport counts ``n_micro``
    payloads on each ``(c, N)`` link, each ``fwd_wire_bytes``, and nothing
    else (no cotangent without a backward)."""
    cfg = _cfg()
    hub = _hubs(TQC, tsplit.HubConfig)[name]
    step = tsched.build_hub_step(cfg, hub, N_MICRO, MB, SEQ)
    with torch.no_grad():
        loss, per_client, wire = step(_params(ref, name), *_batch(cfg, 3, 2))
    # the reference's "het" run is its grad step: the same forward
    np.testing.assert_allclose(float(loss), ref[name + "/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(per_client.numpy(), ref[name + "/per_client"],
                               rtol=LOSS_RTOL)
    table = thub.hub_wire_bytes(cfg, hub, MB, SEQ)
    if name == "grouped":
        assert wire == float(ref["grouped/wire"])
    assert wire == float(table["fwd_tick"])
    assert dict(step.transport.bytes) == {
        link: entry["fwd"] * N_MICRO for link, entry in
        table["links"].items()}
    assert dict(step.transport.payloads) == {(c, 3): N_MICRO
                                             for c in range(3)}


@pytest.mark.parametrize("name", ["het", "het_bwd"])
def test_hub_grads_match_reference(ref, name):
    """``build_hub_grad_step``: the loss and each client's CE within
    LOSS_RTOL; every gradient leaf (the client stages', the server's, and
    the shared embed / head / final norm summed over the clients) at
    cosine >= GRAD_COS with its norm within GRAD_NORM_RTOL; the wire bytes
    exactly; ``n_micro`` payloads on each ``(c, N)`` link and on each
    ``(N, c)`` return, raw or through ``bwd_quant``."""
    cfg = _cfg()
    hub = _hubs(TQC, tsplit.HubConfig)[name]
    grad_step = tsched.build_hub_grad_step(cfg, hub, N_MICRO, MB, SEQ)
    loss, per_client, grads, wire = grad_step(_params(ref, name),
                                              *_batch(cfg, 3, 2))
    np.testing.assert_allclose(float(loss), ref[name + "/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(per_client.numpy(), ref[name + "/per_client"],
                               rtol=LOSS_RTOL)
    assert wire == float(ref[name + "/wire"])
    ours = dict(tree_flatten_with_path(grads))
    theirs = {tuple(k[len(name + "/grads/"):].split("/")): v
              for k, v in ref.items() if k.startswith(name + "/grads/")}
    assert set(ours) == set(theirs) and theirs
    cos = {k: _cos(ours[k].numpy(), theirs[k]) for k in theirs}
    assert min(cos.values()) >= GRAD_COS, cos
    for k in theirs:
        np.testing.assert_allclose(np.linalg.norm(ours[k].numpy()),
                                   np.linalg.norm(theirs[k]),
                                   rtol=GRAD_NORM_RTOL, err_msg=str(k))
    table = thub.hub_wire_bytes(cfg, hub, MB, SEQ)
    expect = {}
    for (src, dst), entry in table["links"].items():
        expect[(src, dst)] = entry["fwd"] * N_MICRO
        expect[(dst, src)] = entry["bwd"] * N_MICRO
    assert dict(grad_step.transport.bytes) == expect
    assert set(grad_step.transport.payloads.values()) == {N_MICRO}


def _train(ref, name, hub, **kw):
    cfg = _cfg()
    batches = [_batch(cfg, 3, 10 + i) for i in range(4)]
    log = []
    out = thub.train_hub(
        cfg, hub,
        thub.AdamWConfig(lr=TRAIN_LR, eps=TRAIN_EPS, weight_decay=0.0),
        batches, micro_batch=MB, seq=SEQ, n_micro=N_MICRO,
        params=_params(ref, "het"), plan_log=log, **kw)
    np.testing.assert_allclose(out["history"], ref[name + "/history"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["per_client"], ref[name + "/per_client"],
                               rtol=LOSS_RTOL)
    assert out["wire_bytes_per_tick"] == float(ref[name + "/wire"])
    assert int(out["opt"]["step"]) == 4
    return log


def test_train_hub_history_matches_reference(ref):
    """Four AdamW steps (TRAIN_LR, TRAIN_EPS) of the lockstep hub over
    2-bit links: the loss history and the last step's per-client CE within
    LOSS_RTOL a step."""
    hub = _hubs(TQC, tsplit.HubConfig)["plain"]
    assert _train(ref, "train", hub) == []


def test_adaptive_hub_plan_log_matches_reference(ref):
    """The per-client re-plan (each client's probe feeds its own entropy
    EMA, each link gets its own plan): the same ``plan_log``, the history
    within LOSS_RTOL, every plan legal (8 widths in 1 - 8, mean <= 2)."""
    hub = _hubs(TQC, tsplit.HubConfig)["plain"]
    log = _train(ref, "adaptive", hub, wire_budget_bytes=BUDGET,
                 plan_groups=8)
    assert log and [s for s, _ in log] == list(ref["adaptive/plan_steps"])
    assert [[list(p) for p in plans] for _, plans in log] == \
        ref["adaptive/plans"].tolist()
    for _, plans in log:
        for p in plans:
            assert len(p) == 8 and all(1 <= w <= 8 for w in p)
            assert sum(p) / len(p) <= 2.0


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [["--bwd-bits", "2"],
                                   ["--wire-budget-bits", "2"]])
def test_entry_point_trains_and_counts_on_the_cpu(capsys, extra):
    """``python -m repro_torch.launch.split_hub --device cpu --reduced``:
    the loss falls, and every link's counted bytes, both directions, equal
    ``hub_wire_bytes`` x shipments."""
    assert thub.main(["--device", "cpu", "--reduced", "--steps", "4",
                      "--n-micro", "2", "--micro-batch", "2", "--seq", "32",
                      "--lr", "5e-3"] + extra) == 0
    out = capsys.readouterr().out
    losses = [float(v) for v in re.search(r"loss ([\d. >-]+) in",
                                          out).group(1).split(" -> ")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    pairs = re.findall(r"counted (\d+) B, hub_wire_bytes x 8 shipments = "
                       r"(\d+) B", out)
    assert len(pairs) == 6 and all(a == b for a, b in pairs), out


def test_entry_point_needs_cuda_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        thub.main(["--reduced", "--steps", "1", "--seq", "16"])
