"""The port's multi-process paths on gloo ranks of this machine's CPU:
``launch/train.py --mesh`` (DTensor placements over a (data, model)
``DeviceMesh``), the split pipeline with each stage in a process of its
own (``launch/split_pipeline.run_ranks`` over ``core/split.DistTransport``)
with the reference's ``quantized_ship`` across the ``pod`` axis as a probe
of its wire, and a failing rank.

Four groups of ranks in all (``launch/dist.spawn``), each rank on one
torch thread.  Parameters cross from the reference with
``repro_torch.bridge.from_jax_params``; inputs come from numpy seeds and
the data pipeline.
"""
import time

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import QuantConfig as JQC  # noqa: E402
from repro.core import roundtrip as jroundtrip  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.core.split import SplitConfig  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch import split_pipeline as sp  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

# the reference's own mesh test (tests/test_mesh_subprocess.py): its
# sharded step against its single-device step
REF_LOSS_ATOL, REF_PARAM_ATOL = 1e-3, 5e-3
# the sharded step against the port's unsharded step, both fp32: the same
# operations split across ranks, so the same up to summation order, which
# AdamW's sign-like first steps can carry to about 1e-6 of a weight
PORT_LOSS_RTOL, PORT_PARAM_ATOL = 1e-6, 1e-5
# the process-a-stage pipeline against the single-process one, fp32:
# gradients summed microbatch by microbatch, and over data replicas
PIPE_LOSS_RTOL, PIPE_GRAD_RTOL, PIPE_GRAD_ATOL = 1e-6, 1e-4, 1e-7
SHIP_ATOL = 1e-4   # the reference's test: the shipped rows vs roundtrip
N_MICRO, MB, SEQ = 2, 4, 16


def _np_leaves(tree):
    """'/'-joined path -> float32 numpy, for a JAX or a port tree."""
    if any(isinstance(x, torch.Tensor)
           for _, x in tree_flatten_with_path(tree)):
        return {"/".join(p): x.detach().float().numpy()
                for p, x in tree_flatten_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(x, np.float32)
            for p, x in flat}


def test_sharded_train_step_matches_reference_and_port():
    """``train --mesh 2x2`` (4 gloo ranks, FSDP specs, llama3_2_3b's 4 / 4
    heads split over the model axis) for 2 steps of batch 8 x 16 from the
    reference's weights: loss and parameters against the reference's
    single-device ``jax.jit(step)`` at its own mesh test's tolerance, and
    against the port's unsharded step."""
    steps, batch, seq = 2, 8, 16
    jcfg = jget_config("llama3_2_3b").reduced()
    key = jax.random.PRNGKey(0)
    jstate = jloop.init_state(key, jcfg, JAdamW(lr=1e-3))
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(jloop.make_train_step(jcfg, JAdamW(lr=1e-3),
                                          total_steps=steps))
    data = jpipeline(jcfg, batch, seq)
    for _ in range(steps):
        jstate, jm = jstep(jstate, next(data), key)

    cfg = get_config("llama3_2_3b").reduced()
    state = tloop.TrainState(
        params=from_jax_params(init, "cpu"),
        opt=tloop.init_opt_state(from_jax_params(init, "cpu"),
                                 AdamWConfig(lr=1e-3)),
        step=torch.zeros((), dtype=torch.int32))
    tstep = tloop.make_train_step(cfg, AdamWConfig(lr=1e-3),
                                  total_steps=steps)
    data = make_pipeline(cfg, batch, seq)
    torch.set_num_threads(1)
    for _ in range(steps):
        state, tm = tstep(state, next(data))

    opts = vars(tlaunch._parser().parse_args(
        ["--arch", "llama3_2_3b", "--steps", str(steps), "--batch",
         str(batch), "--seq", str(seq), "--log-every", "1", "--device",
         "cpu"]))
    opts.update(mesh_shape=(2, 2), init=init, return_params=True)
    out = tlaunch.run_mesh(opts)
    res = out[0]["result"]
    assert len(out) == 4 and len(res["lines"]) == steps
    loss = res["history"][-1][1]["loss"]
    assert abs(loss - float(jm["loss"])) < REF_LOSS_ATOL
    np.testing.assert_allclose(loss, float(tm["loss"]),
                               rtol=PORT_LOSS_RTOL)
    assert res["lines"][-1] == tlaunch.step_line(steps - 1, tm)
    # every rank printed nothing but rank 0 printed the step lines
    assert all("step " not in r["log"] for r in out[1:])
    mesh_p, ref_p = _np_leaves(res["params"]), _np_leaves(jstate.params)
    port_p = _np_leaves(state.params)
    assert mesh_p.keys() == ref_p.keys() == port_p.keys()
    for k in ref_p:
        np.testing.assert_allclose(mesh_p[k], ref_p[k], atol=REF_PARAM_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(mesh_p[k], port_p[k],
                                   atol=PORT_PARAM_ATOL, err_msg=k)


def _pipe_setup(bwd):
    cfg = sp._homogeneous_cfg("llama3_2_3b", reduced=True)
    split = SplitConfig(quant=QuantConfig(method="rdfsq", bits=2),
                        learnable_codec=False)
    params = sp.init_pipeline_params(cfg, 2, seed=3, device="cpu")
    tokens, labels = (torch.as_tensor(a) for a in
                      sp.make_batches(cfg, 1, N_MICRO, MB, SEQ, seed=5)[0])
    torch.set_num_threads(1)
    loss, grads, wire_b = sp.build_pipeline_grad_step(
        cfg, split, bwd, N_MICRO, MB, SEQ)(params, tokens, labels)
    return cfg, split, params, (tokens, labels), (loss, grads, wire_b)


def _check_pipeline(out, ranks, cfg, split, bwd, single):
    """Loss, each stage's gradients and bytes per link of a ``run_ranks``
    grad run against the single-process grad step."""
    loss, grads, wire_b = single
    n_stages, data = ranks
    assert len(out) == n_stages * data
    ref = _np_leaves(grads)
    for r in out:
        res = r["result"]
        np.testing.assert_allclose(res["history"][0], float(loss),
                                   rtol=PIPE_LOSS_RTOL)
        assert res["wire_bytes"] == float(sum(
            sp.pipeline_wire_bytes(cfg, split, MB, SEQ, bwd, data_shards=data
                                   )[k] for k in ("fwd_tick", "bwd_tick")))
        if res["replica"]:
            continue
        s = res["stage"]
        got = _np_leaves(res["grads"])
        keys = [k for k in got if not k.startswith("blocks/")]
        assert sorted(keys) == (["embed/emb"] if s == 0 else
                                ["final_norm", "head/w"])
        for k, g in got.items():
            want = ref[k][s] if k.startswith("blocks/") else ref[k]
            np.testing.assert_allclose(g, want, rtol=PIPE_GRAD_RTOL,
                                       atol=PIPE_GRAD_ATOL, err_msg=k)
    table = sp.pipeline_wire_bytes(cfg, split, MB, SEQ, bwd,
                                   data_shards=data)
    for (src, dst), entry in table["links"].items():
        fwd = sum(r["result"]["bytes"].get((src, dst), 0) for r in out)
        back = sum(r["result"]["bytes"].get((dst, src), 0) for r in out)
        assert (fwd, back) == (entry["fwd"] * N_MICRO,
                               entry["bwd"] * N_MICRO)
        assert sum(r["result"]["payloads"].get((src, dst), 0)
                   for r in out) == N_MICRO * data


def test_pipeline_two_ranks_and_ship_across_pod():
    """Two processes, a stage each, 2-bit cotangents: loss, every stage's
    gradients and ``DistTransport.bytes[link]`` against the single-process
    ``build_pipeline_grad_step`` and ``pipeline_wire_bytes``.  Before the
    run each rank ships its rows of a (4, 8, 64) tensor to the other
    (perm (0, 1), (1, 0)) through ``quantized_ship``: what each receives
    equals the reference's ``roundtrip`` of the other's rows, and the
    gradient of sum(received * 2) is 2.0 (the reference's
    ``test_quantized_ship_across_pod_axis``)."""
    bwd = QuantConfig(method="rdfsq", bits=2)
    cfg, split, params, batch, single = _pipe_setup(bwd)
    x = np.random.RandomState(0).normal(size=(4, 8, 64)).astype(np.float32)
    ship = dict(x=x, quant=QuantConfig(method="rdfsq", bits=2),
                perm=((0, 1), (1, 0)), scale=2.0)
    out = sp.run_ranks(cfg, split, (2, 1), [batch], mode="grad",
                       n_micro=N_MICRO, micro_batch=MB, seq=SEQ,
                       bwd_qcfg=bwd, params=params, device="cpu",
                       return_grads=True, ship=ship, eval=True)
    _check_pipeline(out, (2, 1), cfg, split, bwd, single)
    # the forward-only step (build_gpipe_step's loss), every rank
    loss_f, _ = sp.build_pipeline_step(cfg, split, N_MICRO, MB, SEQ)(
        params, *batch)
    for r in out:
        np.testing.assert_allclose(r["result"]["eval_loss"], float(loss_f),
                                   rtol=PIPE_LOSS_RTOL)
    qcfg = JQC(method="rdfsq", bits=2)
    for r in out:
        s, probe = r["result"]["stage"], r["result"]["ship"]
        other = x[2:] if s == 0 else x[:2]
        ref, _ = jroundtrip(qcfg, other)
        np.testing.assert_allclose(probe["received"].numpy(),
                                   np.asarray(ref), atol=SHIP_ATOL)
        np.testing.assert_allclose(probe["grad"].numpy(), 2.0, atol=1e-5)


def test_pipeline_pod2_data2():
    """Four processes: 2 stages x 2 data replicas, raw cotangents; each
    replica takes half of every microbatch's rows, the gradients are
    summed over a stage's replicas, and every rank returns the
    single-process step's loss; bytes per link are ``pipeline_wire_bytes``
    at ``data_shards=2`` (the reference's per-device slice) summed over
    the replicas."""
    cfg, split, params, batch, single = _pipe_setup(None)
    out = sp.run_ranks(cfg, split, (2, 2), [batch], mode="grad",
                       n_micro=N_MICRO, micro_batch=MB, seq=SEQ,
                       params=params, device="cpu", return_grads=True)
    _check_pipeline(out, (2, 2), cfg, split, None, single)


def test_failing_rank_fails_the_group():
    """A rank that raises (here stage 1, whose probe ships to a stage the
    topology lacks) fails ``spawn`` with its traceback while its peer
    waits on a receive that never comes: the peer is killed, well inside
    the group's timeout."""
    cfg, split = sp._homogeneous_cfg("llama3_2_3b", reduced=True), \
        SplitConfig(quant=QuantConfig(method="rdfsq", bits=2),
                    learnable_codec=False)
    ship = dict(x=np.zeros((4, 8, 64), np.float32),
                quant=QuantConfig(method="rdfsq", bits=2),
                perm=((0, 1), (1, 2)), scale=1.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 .*(exited|raised)"):
        sp.run_ranks(cfg, split, (2, 1), [], mode="grad", n_micro=N_MICRO,
                     micro_batch=MB, seq=SEQ, device="cpu", ship=ship,
                     timeout=60.0)
    assert time.perf_counter() - t0 < 60.0
    with pytest.raises(ValueError, match="module-level functions"):
        dist.spawn(lambda rank, world: None, 1)
