"""SplitLoRA in the port (``peft/lora.py``, the LoRA stages of
``core/split_stage.py``, ``launch/schedules.py`` and
``launch/split_pipeline.py``, ``train/loop.py``'s adapter state, the
adapter checkpoints and ``ServeEngine(lora_adapters=)``) against the JAX
reference, on the CPU, on ``llama3_2_3b.reduced()`` and
``tinyllava.reduced()`` in fp32.

Adapters come from the reference's ``init_lora_params`` and cross with
``repro_torch.bridge.from_jax_params``.  The reference's pipeline runs (its
SplitLoRA grad step and ``train_pipeline(lora_rank=4)``) are one SPMD
program over a ``pod`` mesh axis, so they run in one subprocess for the
whole module, on four fake CPU devices and a (2, 1) mesh, started with the
module's first test.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import peft as jpeft  # noqa: E402
from repro import wq as jwq  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.quantizers import QuantConfig as JQC  # noqa: E402
from repro.core.split import SplitConfig as JSC  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.serve import decode as jsd  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import checkpoint, peft, wq  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core.quantizers import QuantConfig as TQC  # noqa: E402
from repro_torch.core.split_stage import (  # noqa: E402
    init_stage_params, run_blocks, stage_blocks)
from repro_torch.launch import split_pipeline as tsp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import AdamWConfig, param_bytes  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import (tree_flatten_with_path,  # noqa: E402
                                    tree_leaves, tree_map)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama3_2_3b", "tinyllava"]
FOLD_RTOL = 1e-6   # merged / applied leaves vs the reference's (fp32)
FWD_ATOL = 1e-5    # logits of the merged forward vs the reference's
LOSS_RTOL = 1e-4   # pipeline losses and histories vs the reference
GRAD_COS = 0.9999  # per-leaf adapter-gradient cosine vs the reference
STEP_RTOL = 1e-6   # one adapter AdamW step vs the reference's
RANK = 4
N_MICRO, MB, SEQ = 2, 2, 16  # the grad steps' shapes
# dryrun_lora_train's settings (repro/launch/split_pipeline.py): 2
# microbatches of 4 x 32 tokens, lr 3e-2, here 4 steps
T_MICRO, T_MB, T_SEQ, T_LR, T_STEPS = 2, 4, 32, 3e-2, 4
# results/split_pipeline.json, key "lora": adapter bytes = moment bytes
ADAPTER_BYTES = 139264

REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["REPRO_QUANT_IMPL"] = "jnp"
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.quantizers import QuantConfig
from repro.core.split import SplitConfig
from repro.launch import split_pipeline as sp
from repro.optim import AdamWConfig, param_bytes

res = {{}}
R2 = QuantConfig(method="rdfsq", bits=2)
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("pod", "data"))
split = SplitConfig(quant=R2, learnable_codec=False, n_stages=2)
cfg = sp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=2)

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

def batch(seed, n, mb, seq):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (n, mb, seq)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((n, mb, 1), -100, np.int32)], -1)
    return tok, lab

params = sp.init_pipeline_params(jax.random.PRNGKey(0), cfg, 2,
                                 lora_rank={rank})
# B = 0 makes stage 0's adapter gradients vanish at the first step; the
# grad-step comparison takes a nonzero B
gparams = dict(params, adapters=jax.tree_util.tree_map(
    lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7), a.shape),
    params["adapters"]))
flat(gparams, "grad/params/")
tok, lab = batch(1, {n_micro}, {mb}, {seq})
for name, bwd in (("raw", None), ("r2", R2)):
    with mesh:
        loss, grads, wb = jax.jit(sp.build_pipeline_grad_step(
            cfg, mesh, split, bwd, {n_micro}, {mb}, {seq},
            lora_rank={rank}))(gparams, tok, lab)
    res[name + "/loss"] = np.asarray(loss)
    res[name + "/wire"] = np.asarray(wb)
    flat(grads, name + "/grads/")

flat(params, "train/params/")
batches = [batch(10 + i, {t_micro}, {t_mb}, {t_seq}) for i in range({t_steps})]
opt_cfg = AdamWConfig(lr={t_lr}, weight_decay=0.0)
out, opt, hist, wb = sp.train_pipeline(
    cfg, mesh, split, opt_cfg, iter(batches), n_micro={t_micro},
    micro_batch={t_mb}, seq={t_seq}, params=params, lora_rank={rank})
res["train/history"] = np.asarray(hist)
res["train/wire"] = np.asarray(wb)
res["train/m_bytes"] = np.asarray(param_bytes(opt["m"]))
flat(out["adapters"], "train/adapters/")
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread, as in
    tests/test_torch_split_hub.py: the suite runs a worker a core or so,
    and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _ref_run(tmp_path_factory):
    """Starts the reference's pipeline runs with the module's first test,
    so that the tests before ``ref`` overlap them."""
    path = tmp_path_factory.mktemp("lora") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    code = textwrap.dedent(REF_SCRIPT.format(
        rank=RANK, n_micro=N_MICRO, mb=MB, seq=SEQ, t_micro=T_MICRO,
        t_mb=T_MB, t_seq=T_SEQ, t_lr=T_LR, t_steps=T_STEPS))
    proc = subprocess.Popen([sys.executable, "-c", code, str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(_ref_run):
    """The reference's SplitLoRA losses, adapter gradients and history."""
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


def _jflat(tree):
    return {tuple(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {path: leaf.detach().numpy()
            for path, leaf in tree_flatten_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0, rank=RANK):
    """The reference's reduced model, its adapters (B at scale 0.05, so
    that they move the model) and both carried into the port (made once a
    module; no test changes them in place)."""
    jcfg = jget_config(arch).reduced()
    jp = _jinit(jcfg, seed)
    jad = jax.jit(lambda k, p: jpeft.init_lora_params(k, p, rank,
                                                      b_scale=0.05))(
        jax.random.PRNGKey(seed + 5), jp)
    return jcfg, jp, jad, from_jax_params(jp, "cpu"), \
        from_jax_params(jad, "cpu")


def _jinit(jcfg, seed):
    """The reference's ``init_params``, jitted (a second, where eager
    dispatch takes several)."""
    return jax.jit(lambda k: jtf.init_params(k, jcfg))(
        jax.random.PRNGKey(seed))


def _batch(arch, cfg):
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (2, 12))
           .astype(np.int32)}
    if cfg.modality == "vlm":
        out["image_embeds"] = rng.normal(
            size=(2, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# sites, init, merge / apply / unmerge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lora_sites_match_reference(arch):
    """The site paths and shapes equal the reference's ``lora_sites``, on
    the model's tree and on the stage-stacked pipeline tree; no norm,
    bias or embedding is a site."""
    _, jp, _, tp, _ = _model(arch)
    ours = [(p, tuple(w.shape)) for p, w in peft.lora_sites(tp)]
    theirs = [(p, tuple(w.shape)) for p, w in jpeft.lora_sites(jp)]
    assert ours == theirs and ours
    assert all(p[-1].startswith("w") for p, _ in ours)
    from repro.core.split_stage import init_stage_params as jinit

    cfg = get_config("llama3_2_3b").reduced()
    stacked = init_stage_params(cfg, 2, device="cpu")["blocks"]
    jcfg = jget_config("llama3_2_3b").reduced()
    jstacked = jax.eval_shape(
        lambda: jinit(jax.random.PRNGKey(0), jcfg, 2))["blocks"]
    assert [(p, tuple(w.shape)) for p, w in peft.lora_sites(stacked)] == \
        [(p, tuple(w.shape)) for p, w in jpeft.lora_sites(jstacked)]


@pytest.mark.parametrize("arch", ARCHS)
def test_merge_and_apply_match_reference(arch):
    """The port's ``merge_lora`` / ``apply_lora`` leaves within FOLD_RTOL of
    the reference's ``merge_lora`` (fp32; the rank-4 product summed in
    another order); the port's merge equals its apply bit for bit;
    ``unmerge`` recovers the base within FOLD_RTOL; leaves that are not
    sites are the base's own tensors."""
    _, jp, jad, tp, tad = _model(arch)
    ref = _jflat(jax.jit(jpeft.merge_lora)(jp, jad))
    merged, applied = peft.merge_lora(tp, tad), peft.apply_lora(tp, tad)
    sites = {p for p, _ in peft.lora_sites(tp)}
    for path, leaf in _tflat(merged).items():
        np.testing.assert_allclose(leaf, ref[path], rtol=FOLD_RTOL,
                                   atol=FOLD_RTOL * np.abs(ref[path]).max())
    for (pa, a), (_, b) in zip(tree_flatten_with_path(merged),
                               tree_flatten_with_path(applied)):
        assert torch.equal(a, b), pa
    base = _tflat(tp)
    for path, leaf in _tflat(peft.unmerge_lora(merged, tad)).items():
        np.testing.assert_allclose(leaf, base[path], rtol=FOLD_RTOL,
                                   atol=FOLD_RTOL * np.abs(base[path]).max())
    moved = [p for p, a in _tflat(merged).items()
             if not np.array_equal(a, base[p])]
    assert set(moved) == sites
    with pytest.raises(ValueError, match="not an adapter tree"):
        peft.merge_lora(tp, tp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lora_params_shapes_and_scale(arch, dtype):
    """Shapes as the reference's, each in its site's dtype; B = 0; A's
    standard deviation times sqrt(d_in) within 10% of 1 over all sites
    (some 35 000 draws); the rank scales the count."""
    _, jp, _, tp, _ = _model(arch)
    tp = tree_map(lambda t: t.to(dtype), tp)
    ad = peft.init_lora_params(torch.Generator().manual_seed(0), tp, RANK)
    jad = jax.eval_shape(lambda: jpeft.init_lora_params(
        jax.random.PRNGKey(0), jp, RANK))
    assert {p: tuple(a.shape) for p, a in tree_flatten_with_path(ad)} == \
        {tuple(str(k.key) for k in p): tuple(a.shape) for p, a in
         jax.tree_util.tree_flatten_with_path(jad)[0]}
    z = []
    for path, w in peft.lora_sites(tp):
        site = ad
        for name in path:
            site = site[name]
        assert site["lora_a"].dtype == site["lora_b"].dtype == dtype
        assert not site["lora_b"].any()
        z.append(site["lora_a"].float().reshape(-1) * w.shape[-2] ** 0.5)
    assert abs(float(torch.cat(z).std()) - 1.0) < 0.1
    assert peft.adapter_param_count(peft.init_lora_params(
        torch.Generator().manual_seed(0), tp, 2 * RANK)) == \
        2 * peft.adapter_param_count(ad) == \
        2 * jpeft.adapter_param_count(jad)
    with pytest.raises(ValueError, match="rank"):
        peft.init_lora_params(torch.Generator(), tp, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_forward_matches_reference(arch):
    """The port's forward on merged params against the reference's forward
    on its merged params (logits within FWD_ATOL); adapters with B = 0
    change nothing."""
    jcfg, jp, jad, tp, tad = _model(arch)
    cfg = get_config(arch).reduced()
    batch = _batch(arch, cfg)
    jlogits = jax.jit(lambda p, a, b: jtf.forward(
        jpeft.merge_lora(p, a), jcfg, b)[0])(
            jp, jad, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, _ = ttf.forward(peft.merge_lora(tp, tad), cfg, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=FWD_ATOL)
    zero = peft.init_lora_params(torch.Generator().manual_seed(1), tp, RANK)
    assert torch.equal(ttf.forward(peft.merge_lora(tp, zero), cfg, tb)[0],
                       ttf.forward(tp, cfg, tb)[0])


def test_stack_adapter_path_equals_premerged():
    """``run_blocks`` with adapters (each layer folded in the executor's
    loop) equals the blocks merged up front, bit for bit: the invariant
    behind token-exact merged serving."""
    cfg = get_config("llama3_2_3b").reduced()
    params = init_stage_params(cfg, 2, lora_rank=RANK, seed=2,
                               device="cpu")
    blocks = stage_blocks(params, 0)
    ad = peft.init_lora_params(torch.Generator().manual_seed(3), blocks,
                               RANK, b_scale=0.05)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    pos = torch.arange(8, dtype=torch.int32)
    assert torch.equal(run_blocks(cfg, blocks, x, pos, adapters=ad),
                       run_blocks(cfg, peft.merge_lora(blocks, ad), x, pos))
    assert params["adapters"]["attn"]["wq"]["lora_a"].shape == \
        (2, cfg.n_layers // 2, cfg.d_model, RANK)


# ---------------------------------------------------------------------------
# the adapter state, checkpoints
# ---------------------------------------------------------------------------

def test_adapter_state_matches_reference():
    """``init_adapter_state``: moments over the adapters alone (their bytes
    equal ``adapter_bytes``); one ``apply_adapter_gradients`` step within
    STEP_RTOL of the reference's from the same parameters and gradients;
    every base leaf the same tensor, bit-frozen; in place with
    ``donate``; a ValueError without adapters."""
    jcfg = jget_config("llama3_2_3b").reduced()
    from repro.core.split_stage import init_stage_params as jinit

    jparams = jax.jit(lambda k: jinit(k, jcfg, 2, lora_rank=RANK))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    jgrads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        jparams["adapters"])
    opt = dict(lr=1e-2, weight_decay=0.0)
    jstate, _ = jax.jit(lambda p, g: jloop.apply_adapter_gradients(
        jloop.init_adapter_state(p, JAdamW(**opt)), g, JAdamW(**opt)))(
            jparams, jgrads)

    params = from_jax_params(jparams, "cpu")
    base = {k: v for k, v in params.items() if k != "adapters"}
    before = {p: t.clone() for p, t in tree_flatten_with_path(base)}
    state = tloop.init_adapter_state(params, AdamWConfig(**opt))
    assert param_bytes(state.opt["m"]) == \
        peft.adapter_bytes(params["adapters"]) == ADAPTER_BYTES
    m_before = state.opt["m"]["attn"]["wq"]["lora_a"]
    new, _ = tloop.apply_adapter_gradients(
        state, from_jax_params(jgrads, "cpu"), AdamWConfig(**opt),
        donate=True)
    ref = _jflat(jstate.params["adapters"])
    for path, leaf in _tflat(new.params["adapters"]).items():
        np.testing.assert_allclose(leaf, ref[path], rtol=STEP_RTOL,
                                   atol=STEP_RTOL)
    for k in base:
        assert new.params[k] is params[k]
    for path, t in tree_flatten_with_path(
            {k: v for k, v in new.params.items() if k != "adapters"}):
        assert torch.equal(t, before[path]), path
    assert new.opt["m"]["attn"]["wq"]["lora_a"] is m_before
    assert int(new.step) == 1
    with pytest.raises(ValueError, match="adapters"):
        tloop.init_adapter_state(base, AdamWConfig(**opt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adapter_checkpoint_bit_exact_and_small(tmp_path, dtype):
    """``save_adapters`` -> ``load_adapters`` bit for bit (bf16 too), the
    file far smaller than the full checkpoint, a tree that is not
    adapters-only refused; the file is the reference's layout (its
    ``load_adapters`` reads it)."""
    _, jp, jad, tp, tad = _model("llama3_2_3b")
    tad = tree_map(lambda t: t.to(dtype), tad)
    full, path = tmp_path / "full.npz", tmp_path / "adapters.npz"
    checkpoint.save(str(full), tp)
    checkpoint.save_adapters(str(path), tad)
    assert path.stat().st_size < full.stat().st_size / 10
    template = tree_map(torch.zeros_like, tad)
    back = checkpoint.load_adapters(str(path), template)
    for (pa, a), (_, b) in zip(tree_flatten_with_path(tad),
                               tree_flatten_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if dtype == torch.bfloat16 else a,
            b.view(torch.int16) if dtype == torch.bfloat16 else b), pa
    from repro.checkpoint import load_adapters as jload

    jback = jload(str(path), jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, jnp.bfloat16 if dtype ==
                            torch.bfloat16 else a.dtype), jad))
    for path_, leaf in _jflat(jback).items():
        np.testing.assert_array_equal(
            leaf.astype(np.float32),
            _tflat(tree_map(lambda t: t.float(), tad))[path_])
    with pytest.raises(ValueError, match="not an adapter tree"):
        checkpoint.save_adapters(str(tmp_path / "bad.npz"), tp)
    with pytest.raises(ValueError, match="empty"):
        checkpoint.save_adapters(str(tmp_path / "empty.npz"), {})


# ---------------------------------------------------------------------------
# SplitLoRA on the pipeline, against the reference's
# ---------------------------------------------------------------------------

def _pipe_split():
    return tsplit.SplitConfig(quant=TQC(method="rdfsq", bits=2),
                              learnable_codec=False, n_stages=2)


def _pipe_batch(cfg, seed, n, mb, seq):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (n, mb, seq)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((n, mb, 1), -100, np.int32)], -1)
    return torch.as_tensor(tok), torch.as_tensor(lab)


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("bwd", ["raw", "r2"])
def test_lora_grad_step_matches_reference(ref, bwd):
    """``build_pipeline_grad_step(lora_rank=4)`` over the 2-bit link, the
    cotangent raw or through 2-bit RD-FSQ: the loss within LOSS_RTOL, a
    gradient for every adapter leaf and for nothing else, each at cosine
    >= GRAD_COS with the reference's; no base leaf takes a gradient; both
    directions of the link counted."""
    cfg = tsp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=2)
    params = from_jax_params(_unflatten(ref, "grad/params/"), "cpu")
    bq = None if bwd == "raw" else TQC(method="rdfsq", bits=2)
    step = tsp.build_pipeline_grad_step(cfg, _pipe_split(), bq, N_MICRO, MB,
                                        SEQ, lora_rank=RANK)
    loss, grads, wire = step(params, *_pipe_batch(cfg, 1, N_MICRO, MB, SEQ))
    np.testing.assert_allclose(float(loss), ref[bwd + "/loss"],
                               rtol=LOSS_RTOL)
    assert wire == float(ref[bwd + "/wire"])
    ours = _tflat(grads)
    theirs = {tuple(k[len(bwd + "/grads/"):].split("/")): v
              for k, v in ref.items() if k.startswith(bwd + "/grads/")}
    assert set(ours) == set(theirs) == set(_tflat(params["adapters"]))
    cos = {k: _cos(ours[k], theirs[k]) for k in theirs}
    assert min(cos.values()) >= GRAD_COS, cos
    assert all(t.grad is None and not t.requires_grad
               for t in tree_leaves(params))
    table = tsp.pipeline_wire_bytes(cfg, _pipe_split(), MB, SEQ, bq)
    entry = table["links"][(0, 1)]
    assert dict(step.transport.bytes) == {(0, 1): entry["fwd"] * N_MICRO,
                                          (1, 0): entry["bwd"] * N_MICRO}


def test_lora_grad_step_under_remat_equals_plain():
    """The card runs llama with remat (each layer under
    ``torch.utils.checkpoint``, its adapters among the checkpointed
    inputs): the SplitLoRA loss and adapter gradients equal the plain
    loop's, to rounding."""
    cfg = tsp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=2)
    params = tsp.init_pipeline_params(cfg, 2, RANK, seed=4, device="cpu")
    params["adapters"] = tree_map(lambda t: t + 0.05, params["adapters"])
    batch = _pipe_batch(cfg, 5, N_MICRO, MB, SEQ)
    out = {}
    for remat in (False, True):
        step = tsp.build_pipeline_grad_step(
            dataclasses.replace(cfg, remat=remat), _pipe_split(), None,
            N_MICRO, MB, SEQ, lora_rank=RANK)
        out[remat] = step(params, *batch)[:2]
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                rel=1e-6)
    for (pa, a), (_, b) in zip(tree_flatten_with_path(out[True][1]),
                               tree_flatten_with_path(out[False][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=str(pa))


def test_lora_train_pipeline_matches_reference(ref):
    """``train_pipeline(lora_rank=4)`` at ``dryrun_lora_train``'s settings
    (2 microbatches of 4 x 32 tokens, lr 3e-2, 4 steps) from the
    reference's parameters: adapter bytes = moment bytes = 139 264
    (``results/split_pipeline.json``); the loss falls; every base leaf
    bit-frozen; the history within LOSS_RTOL of the reference's a step,
    the trained adapters at cosine >= GRAD_COS."""
    cfg = tsp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=2)
    params = from_jax_params(_unflatten(ref, "train/params/"), "cpu")
    base = {p: t.clone() for p, t in tree_flatten_with_path(
        {k: v for k, v in params.items() if k != "adapters"})}
    batches = [_pipe_batch(cfg, 10 + i, T_MICRO, T_MB, T_SEQ)
               for i in range(T_STEPS)]
    out, opt, hist, wire = tsp.train_pipeline(
        cfg, _pipe_split(), AdamWConfig(lr=T_LR, weight_decay=0.0), batches,
        n_micro=T_MICRO, micro_batch=T_MB, seq=T_SEQ, params=params,
        lora_rank=RANK)
    assert peft.adapter_bytes(out["adapters"]) == param_bytes(opt["m"]) \
        == int(ref["train/m_bytes"]) == ADAPTER_BYTES
    assert hist[-1] < hist[0]
    for path, t in tree_flatten_with_path(
            {k: v for k, v in out.items() if k != "adapters"}):
        assert torch.equal(t, base[path]), path
    np.testing.assert_allclose(hist, ref["train/history"], rtol=LOSS_RTOL)
    assert wire == float(ref["train/wire"])
    theirs = _unflatten(ref, "train/adapters/")
    ours = _tflat(out["adapters"])
    for path, leaf in _jflat(theirs).items():
        assert _cos(ours[path], leaf) >= GRAD_COS, path


def test_lora_train_pipeline_with_adaptive_replan():
    """SplitLoRA together with the adaptive re-plan, from the port's own
    seed: the plan is re-made between steps from the base blocks' probe,
    the loss falls, the base stays bit-frozen, and the transport counts
    the plans' bytes."""
    cfg = tsp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=2)
    params = tsp.init_pipeline_params(cfg, 2, RANK, seed=3, device="cpu")
    base = {p: t.clone() for p, t in tree_flatten_with_path(
        {k: v for k, v in params.items() if k != "adapters"})}
    log, transport = [], tsplit.Transport()
    _, opt, hist, _ = tsp.train_pipeline(
        cfg, _pipe_split(), AdamWConfig(lr=T_LR, weight_decay=0.0),
        tsp.make_batches(cfg, 3, N_MICRO, MB, SEQ), n_micro=N_MICRO,
        micro_batch=MB, seq=SEQ, params=params, lora_rank=RANK,
        wire_budget_bytes=MB * SEQ * cfg.d_model * 2 / 8, plan_groups=8,
        plan_log=log, transport=transport)
    assert log and hist[-1] < hist[0] and int(opt["step"]) == 3
    for path, t in tree_flatten_with_path(
            {k: v for k, v in params.items() if k != "adapters"}):
        assert torch.equal(t, base[path]), path
    assert transport.payloads == {(0, 1): 3 * N_MICRO, (1, 0): 3 * N_MICRO}


# ---------------------------------------------------------------------------
# merged serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _serve_case():
    """The reference test's setup (tests/test_peft_lora.py::
    test_engine_serves_merged_adapters_token_exact): llama3_2_3b reduced
    with the split disabled, adapters of rank 4 with B at scale 0.05, two
    prompts of 8 tokens, 8 new, pages of 4."""
    over = dict(split=JSC(quant=JQC(method="identity"),
                          learnable_codec=False, enabled=False))
    jcfg = dataclasses.replace(jget_config("llama3_2_3b").reduced(), **over)
    cfg = dataclasses.replace(
        get_config("llama3_2_3b").reduced(),
        split=tsplit.SplitConfig(quant=TQC(method="identity"),
                                 learnable_codec=False, enabled=False))
    jp = _jinit(jcfg, 0)
    jad = jax.jit(lambda k, p: jpeft.init_lora_params(
        k, p, rank=RANK, b_scale=0.05))(jax.random.PRNGKey(5), jp)
    toks = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    return jcfg, cfg, jp, jad, toks


def _engine(cls, params, cfg, toks, **kw):
    b, p, n_new, pg = toks.shape[0], toks.shape[1], 8, 4
    eng = cls(params, cfg, n_slots=b, page_size=pg,
              n_pages=1 + b * ((p + n_new) // pg), **kw)
    rids = [eng.submit(list(toks[i]), max_new=n_new) for i in range(b)]
    res = eng.run()
    return np.stack([res[r] for r in rids]), eng


def test_engine_merged_serving_token_exact_vs_reference():
    """``ServeEngine(lora_adapters=)`` against the reference's engine with
    the same adapters: the same tokens; the adapters move the tokens (the
    base engine's differ)."""
    jcfg, cfg, jp, jad, toks = _serve_case()
    ref, _ = _engine(JaxServeEngine, jp, jcfg, toks, lora_adapters=jad)
    tp, tad = from_jax_params(jp, "cpu"), from_jax_params(jad, "cpu")
    out, _ = _engine(ServeEngine, tp, cfg, toks, lora_adapters=tad,
                     device="cpu")
    np.testing.assert_array_equal(out, ref)
    base, _ = _engine(ServeEngine, tp, cfg, toks, device="cpu")
    assert not np.array_equal(base, out)


def test_engine_merged_equals_generate_on_applied_params():
    """The port's merged engine is token-exact against its own static
    ``generate`` on ``apply_lora``'s params (the reference test's
    check), and against the reference's ``generate`` on its applied
    params."""
    jcfg, cfg, jp, jad, toks = _serve_case()
    tp, tad = from_jax_params(jp, "cpu"), from_jax_params(jad, "cpu")
    out, eng = _engine(ServeEngine, tp, cfg, toks, lora_adapters=tad,
                       device="cpu")
    gen = tsd.generate(peft.apply_lora(tp, tad), cfg,
                       {"tokens": torch.as_tensor(toks)}, n_new=8,
                       cache_len=16)
    np.testing.assert_array_equal(out, gen.numpy())
    jgen = jsd.generate(jpeft.apply_lora(jp, jad), jcfg,
                        {"tokens": jnp.asarray(toks)}, n_new=8,
                        cache_len=16)
    np.testing.assert_array_equal(out, np.asarray(jgen))
    for (pa, a), (_, b) in zip(
            tree_flatten_with_path(eng.params),
            tree_flatten_with_path(peft.apply_lora(tp, tad))):
        assert torch.equal(a, b), pa


def test_engine_merge_then_pack_codes_match_reference():
    """``ServeEngine(lora_adapters=, weight_quant="int4")`` merges before
    it packs: every packed store bit-identical to the reference's
    ``quantize_params(merge_lora(...))``, and the engine serves."""
    jcfg, cfg, jp, jad, toks = _serve_case()
    wcfg = jwq.parse_weight_quant("int4")
    jq = jax.jit(lambda p, a: jwq.quantize_params(
        jpeft.merge_lora(p, a), wcfg)[0])(jp, jad)
    tp, tad = from_jax_params(jp, "cpu"), from_jax_params(jad, "cpu")
    out, eng = _engine(ServeEngine, tp, cfg, toks, lora_adapters=tad,
                       weight_quant="int4", device="cpu")
    is_store = lambda x: isinstance(x, jwq.PackedLinear)  # noqa: E731
    flat = jax.tree_util.tree_flatten_with_path(jq, is_leaf=is_store)[0]
    stores = 0
    for path, leaf in flat:
        node = eng.params
        for p in path:
            node = node[str(p.key)]
        if is_store(leaf):
            stores += 1
            assert isinstance(node, wq.PackedLinear)
            for name in ("codes", "scales", "mins"):
                np.testing.assert_array_equal(
                    getattr(node, name).numpy().view(np.uint8),
                    np.asarray(getattr(leaf, name)).view(np.uint8))
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert stores == 7 * jcfg.n_layers and out.shape == (2, 8)
