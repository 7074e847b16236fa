"""The port's split pipeline (``configs/llama3_2_3b.py``, the ``text``
modality, ``core/split.py``'s wire, ``core/split_stage.py``,
``launch/schedules.py``, ``launch/split_pipeline.py``) against the JAX
reference, on the CPU, on reduced llama3_2_3b in fp32.

The reference's pipeline is one SPMD program over a ``pod`` mesh axis, so
it runs in a subprocess with four fake CPU devices (as
``tests/test_mesh_subprocess.py`` runs its meshes), on meshes (2, 1) and
(4, 1): one data shard, so no statistic is split across shards.  Its
outputs cross as numpy arrays, its parameters through
``repro_torch.bridge.from_jax_params``.
"""
import dataclasses
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

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import quantizers as JQ  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core.quantizers import QuantConfig as JQC  # noqa: E402
from repro.launch import schedules as jsched  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core.quantizers import QuantConfig as TQC  # noqa: E402
from repro_torch.core.split_stage import (  # noqa: E402
    chain_programs, embed_tokens, head_ce, init_stage_params, run_blocks,
    stage_blocks)
from repro_torch.launch import schedules as tsched  # noqa: E402
from repro_torch.launch import split_pipeline as tsp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4   # pipeline losses and 4-step histories vs the reference
GRAD_COS = 0.9999  # per-leaf gradient cosine vs the reference
FWD_ATOL = 1e-5    # the text forward's logits vs the reference
N_MICRO, MB, SEQ = 2, 2, 16  # the subprocess runs' shapes


def _split(quant, n_stages=2, stage_quants=()):
    return dict(quant=quant, learnable_codec=False, n_stages=n_stages,
                stage_quants=stage_quants)


# ---------------------------------------------------------------------------
# configs and the text modality
# ---------------------------------------------------------------------------

def test_llama_config_matches_reference():
    """llama3_2_3b and its reduced() equal the reference's field by field
    (reduced: 2 layers, d 256, 4 / 4 heads, head_dim 64, fp32)."""
    ours, ref = get_config("llama3_2_3b"), jget_config("llama3_2_3b")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) \
        == dataclasses.asdict(ref.reduced())
    r = ours.reduced()
    assert (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.head_dim,
            r.compute_dtype) == (2, 256, 4, 4, 64, "float32")
    assert ours.head_dim == 128 and ours.split.resolve_cut(28) == 14


def test_text_forward_matches_reference():
    """The text modality (tokens in, no connector) through the whole
    forward, the in-graph cut included: logits within FWD_ATOL."""
    cfg = get_config("llama3_2_3b").reduced()
    jparams = jtf.init_params(jax.random.PRNGKey(3), jget_config(
        "llama3_2_3b").reduced())
    assert "connector" not in jparams
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jlogits, _ = jtf.forward(jparams, jget_config("llama3_2_3b").reduced(),
                             {"tokens": jnp.asarray(tokens)})
    params = from_jax_params(jparams, "cpu")
    logits, _ = ttf.forward(params, cfg, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=FWD_ATOL)
    ours = ttf.init_params(cfg, device="cpu")
    assert "connector" not in ours
    assert {k: tuple(v.shape) for k, v in tree_flatten_with_path(ours)} == {
        tuple(str(p.key) for p in k): tuple(v.shape) for k, v in
        jax.tree_util.tree_flatten_with_path(jparams)[0]}


def test_audio_modality_still_raises():
    """The audio modality on llama's reduced config is ported: the
    reference's tree (a (2, V, d) embedding, a (2, d, V) head) and its
    (B, S, 2, V) logits from the same weights."""
    upd = dict(modality="audio", n_codebooks=2)
    cfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), **upd)
    jcfg = dataclasses.replace(jget_config("llama3_2_3b").reduced(), **upd)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    ours = ttf.init_params(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in tree_flatten_with_path(ours)} == {
        tuple(str(p.key) for p in k): tuple(v.shape) for k, v in
        jax.tree_util.tree_flatten_with_path(jparams)[0]}
    codes = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 2, 12)).astype(np.int32)
    jlogits, _ = jtf.forward(jparams, jcfg, {"codes": jnp.asarray(codes)})
    logits, _ = ttf.forward(from_jax_params(jparams, "cpu"), cfg,
                            {"codes": torch.as_tensor(codes)})
    assert tuple(logits.shape) == (2, 12, 2, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=FWD_ATOL)


# ---------------------------------------------------------------------------
# the wire: quantized_ship, Transport, WireLink
# ---------------------------------------------------------------------------

# codec -> the reference backend whose decode the port's wire reproduces
# bit for bit: RD-FSQ's flat-stream decode (the reference's CPU default),
# NF's kernel layout with the block range rounded to fp16 (ROADMAP, the
# contract: "The kernel NF decode rounds the block range to fp16")
SHIP_CODECS = [(dict(method="rdfsq", bits=2), "jnp"),
               (dict(method="rdfsq", bits=4), "jnp"),
               (dict(method="rdfsq", group_widths=(1, 2, 4, 8)), "jnp"),
               (dict(method="nf", bits=4), "pallas"),
               (dict(method="identity"), "jnp")]


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec,impl", SHIP_CODECS)
def test_quantized_ship_forward_matches_reference(codec, impl, dtype):
    """The ship's forward equals the reference's decode(encode(x)) bit for
    bit.  One exception, bounded to one ulp of the largest output: NF in
    fp32, where the Pallas decode in interpret mode fuses an FMA (ROADMAP,
    behaviours the port does not copy)."""
    jx, tx = _x((2, 16, 256), dtype)
    ref = JQ.decode(JQC(**codec), JQ.encode(JQC(**codec), jx, impl=impl))
    out = tsplit.quantized_ship(TQC(**codec), tx, tsplit.Transport(),
                                ((0, 1),))
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == tx.dtype
    if codec["method"] == "nf" and dtype == "float32":
        ulp = float(np.spacing(np.abs(ref).max()))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ulp)
    else:
        np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_ship_backward_matches_reference(dtype):
    """Without ``bwd_quant`` the cotangent returns unchanged (the paper's
    scope); with it, it equals the VJP of the reference's
    ``quantize_cotangent`` (decode(encode(g)) in g's dtype), bit for bit."""
    jx, tx = _x((2, 16, 256), dtype, seed=1)
    jg, tg = _x((2, 16, 256), dtype, seed=2)
    q = dict(method="rdfsq", bits=2)
    for bwd in (None, dict(method="rdfsq", bits=2)):
        x = tx.clone().requires_grad_()
        y = tsplit.quantized_ship(TQC(**q), x, tsplit.Transport(),
                                  ((0, 1),),
                                  None if bwd is None else TQC(**bwd))
        (g,) = torch.autograd.grad(y, x, tg)
        if bwd is None:
            assert torch.equal(g, tg)
            continue
        _, vjp = jax.vjp(lambda a: jsplit.quantize_cotangent(JQC(**bwd), a),
                         jx)
        (ref,) = vjp(jg)
        assert g.dtype == tg.dtype
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


LINK_QUANTS = [dict(method="rdfsq", bits=2), dict(method="rdfsq", bits=4),
               dict(method="nf", bits=4), dict(method="identity"),
               dict(method="fsq", group_widths=(3,) * 8)]


@pytest.mark.parametrize("bwd", [None, dict(method="rdfsq", bits=2)])
@pytest.mark.parametrize("quant", LINK_QUANTS)
def test_counted_bytes_match_reference_wirelink(quant, bwd):
    """The transport's counted bytes of one ship, each way, equal the
    reference's ``WireLink.fwd_wire_bytes`` / ``bwd_wire_bytes``, and the
    port's own shape-only counts agree."""
    jlink = jsplit.WireLink(src=0, dst=1, quant=JQC(**quant),
                            bwd_quant=None if bwd is None else JQC(**bwd))
    link = tsplit.WireLink(src=0, dst=1, quant=TQC(**quant),
                           bwd_quant=None if bwd is None else TQC(**bwd))
    for dtype in ("float32", "bfloat16"):
        jx, tx = _x((2, 16, 256), dtype)
        sds = jax.ShapeDtypeStruct(jx.shape, jx.dtype)
        transport = tsplit.Transport()
        x = tx.clone().requires_grad_()
        y = link.ship(x, transport)
        y.backward(torch.ones_like(y))
        assert transport.bytes[(0, 1)] == jlink.fwd_wire_bytes(sds) \
            == link.fwd_wire_bytes(tx.shape, tx.dtype)
        assert transport.bytes[(1, 0)] == jlink.bwd_wire_bytes(sds) \
            == link.bwd_wire_bytes(tx.shape, tx.dtype)
        assert transport.payloads == {(0, 1): 1, (1, 0): 1}


def test_transport_sends_fresh_tensors_at_wire_width():
    """A received leaf is a new tensor, never the sender's, and a bf16 leaf
    counts 2 bytes a value (it crosses as uint16)."""
    transport = tsplit.Transport()
    a = torch.randn(3, 5).bfloat16()
    b = transport.send(a, 0, 1)
    assert torch.equal(a, b) and b.data_ptr() != a.data_ptr()
    assert b.dtype == torch.bfloat16 and transport.bytes[(0, 1)] == 30
    a.zero_()
    assert b.abs().sum() > 0


def test_tree_payload_bytes_matches_reference():
    tree = {"a": np.zeros((4, 64), np.float32),
            "b": {"c": np.zeros((2, 128), np.float32)}}
    jtree = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    ttree = {"a": torch.zeros(4, 64), "b": {"c": torch.zeros(2, 128)}}
    for q in (None, dict(method="rdfsq", bits=2), dict(method="nf", bits=4)):
        jq, tq = (None, None) if q is None else (JQC(**q), TQC(**q))
        assert tsplit.tree_payload_bytes(tq, ttree) \
            == jsplit.tree_payload_bytes(jq, jtree)


def test_links_and_groups_match_reference():
    quants = (dict(method="rdfsq", bits=2), dict(method="nf", bits=4),
              dict(method="rdfsq", bits=2))
    jl = jsplit.pipeline_links(jsplit.SplitConfig(**_split(
        JQC(**quants[0]), 4, tuple(JQC(**q) for q in quants))))
    tl = tsplit.pipeline_links(tsplit.SplitConfig(**_split(
        TQC(**quants[0]), 4, tuple(TQC(**q) for q in quants))))
    assert [(x.src, x.dst, dataclasses.asdict(x.quant)) for x in tl] == \
        [(x.src, x.dst, dataclasses.asdict(x.quant)) for x in jl]
    tg, jg = tsplit.group_links(tl), jsplit.group_links(jl)
    assert [[(x.src, x.dst) for x in g[2]] for g in tg] == \
        [[(x.src, x.dst) for x in g[2]] for g in jg] == [[(0, 1), (2, 3)],
                                                         [(1, 2)]]
    plans = ((1, 2, 3, 2), (2,) * 4, ())
    tsc = tsplit.SplitConfig(**_split(TQC(**quants[0]), 4))
    jsc = jsplit.SplitConfig(**_split(JQC(**quants[0]), 4))
    assert dataclasses.asdict(tsc.with_plans(plans)) \
        == dataclasses.asdict(jsc.with_plans(plans))


def test_m9_parts_raise():
    """The hub's parts that once raised (ROADMAP item M9b) now run: the
    adapter-gradient return's ``grad_trip`` / ``grad_wire_bytes`` and
    ``_link_bytes(grad_sds=)`` on an empty tree count and return nothing;
    with no gradient codec a one-leaf tree goes up and back raw, its bytes
    counted once each way.  SplitLoRA on the chain (M9a) runs too:
    ``chain_programs`` carries the rank, and the step takes the stage-
    stacked adapters."""
    link = tsplit.WireLink(0, 1, TQC(), grad_quant=TQC())
    transport = tsplit.Transport()
    assert link.grad_trip({}, transport) == {}
    assert link.grad_wire_bytes({}) == 0 and not transport.bytes
    table = tsched._link_bytes((link,), (2, 16, 256), torch.float32, 1,
                               grad_sds={})
    assert table["links"][(0, 1)]["grad"] == table["grad_total"] == 0
    raw = tsplit.WireLink(0, 1, TQC())
    leaf = {"g": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    back = raw.grad_trip(leaf, transport)
    assert torch.equal(back["g"], leaf["g"])
    assert dict(transport.bytes) == {(0, 1): 24, (1, 0): 24}
    assert raw.grad_wire_bytes(leaf) == 24
    cfg = get_config("llama3_2_3b").reduced()
    assert {p.lora_rank for p in chain_programs(cfg, 2, lora_rank=2)} == {2}
    params = init_stage_params(cfg, 2, lora_rank=4, device="cpu")
    loss, _ = tsp.build_pipeline_step(cfg, TQC(), 2, 2, 16, lora_rank=4)(
        params, *(t[:, :2, :16] for t in _batch(cfg, 0)))
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="adapters"):
        tsp.build_pipeline_step(cfg, TQC(), 2, 2, 16, lora_rank=4)(
            init_stage_params(cfg, 2, device="cpu"),
            *(t[:, :2, :16] for t in _batch(cfg, 0)))


# ---------------------------------------------------------------------------
# wire accounting: chain_wire_bytes
# ---------------------------------------------------------------------------

# (bits or "mixed", n_stages, micro_batch, seq, data_shards, bwd bits)
CHAIN_CASES = [(16, 4, 4, 16, 2, None), (4, 4, 4, 16, 2, None),
               (2, 4, 4, 16, 2, None), ("mixed", 4, 4, 16, 2, None),
               (2, 2, 8, 32, 1, 2), (16, 2, 2, 1024, 1, None),
               ("mixed", 4, 2, 32, 1, 2)]


def _chain_split(which, n_stages, qc):
    if which == "mixed":
        quants = (qc(method="rdfsq", bits=2), qc(method="nf", bits=4),
                  qc(method="rdfsq", bits=2))
        return dict(quant=quants[0], learnable_codec=False,
                    n_stages=n_stages, stage_quants=quants)
    q = qc(method="identity") if which == 16 else qc(method="rdfsq",
                                                      bits=which)
    return _split(q, n_stages)


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_wire_bytes_matches_reference(case):
    """A shape computation: the per-link table equals the reference's."""
    which, n_stages, mb, seq, shards, bwd = case
    jcfg = jget_config("llama3_2_3b").reduced()
    cfg = get_config("llama3_2_3b").reduced()
    ref = jsched.chain_wire_bytes(
        jcfg, jsplit.SplitConfig(**_chain_split(which, n_stages, JQC)), mb,
        seq, None if bwd is None else JQC(method="rdfsq", bits=bwd),
        data_shards=shards)
    ours = tsched.chain_wire_bytes(
        cfg, tsplit.SplitConfig(**_chain_split(which, n_stages, TQC)), mb,
        seq, None if bwd is None else TQC(method="rdfsq", bits=bwd),
        data_shards=shards)
    assert ours == ref


def test_chain_wire_bytes_pins_the_results():
    """``results/split_pipeline.json`` (the reference's 4-stage smoke: 3
    microbatches of 4 x 16 on 2 data shards): links of 32 768 B in bf16
    and 4 112 B at 2 bits, a reduction of 0.87451171875, and the mixed
    chain's 4 112 / 8 964 / 4 112 B."""
    cfg = get_config("llama3_2_3b").reduced()
    links = {}
    for which in (16, 2, "mixed"):
        table = tsched.chain_wire_bytes(
            cfg, tsplit.SplitConfig(**_chain_split(which, 4, TQC)), 4, 16,
            data_shards=2)
        links[which] = [table["links"][(s, s + 1)]["fwd"] for s in range(3)]
    assert links[16] == [32768] * 3 and links[2] == [4112] * 3
    assert 1 - sum(links[2]) / sum(links[16]) == 0.87451171875
    assert links["mixed"] == [4112, 8964, 4112]


# ---------------------------------------------------------------------------
# the pipeline against the reference's, in a subprocess
# ---------------------------------------------------------------------------

REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.quantizers import QuantConfig
from repro.core.split import SplitConfig
from repro.launch import split_pipeline as sp
from repro.optim import AdamWConfig

N_MICRO, MB, SEQ = {n_micro}, {mb}, {seq}
R2 = QuantConfig(method="rdfsq", bits=2)
MIXED = (R2, QuantConfig(method="nf", bits=4), R2)
res = {{}}

def mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("pod", "data"))

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

def batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (N_MICRO, MB, SEQ)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((N_MICRO, MB, 1), -100, np.int32)], -1)
    return tok, lab

def split(n, quants=()):
    return SplitConfig(quant=R2, learnable_codec=False, n_stages=n,
                       stage_quants=quants)

# name: (config overrides, stages, split, cotangent quant); the mixed chain
# takes the kernel codecs' layout (NF's block range in fp16), as the port
for name, (over, n, sc, bwd) in {{
        "two": ({{}}, 2, split(2), None),
        "two_bwd": ({{}}, 2, split(2), R2),
        "mixed": ({{}}, 4, split(4, MIXED), None),
        "g2": ({{"n_kv_heads": 2}}, 2, split(2), None)}}.items():
    os.environ["REPRO_QUANT_IMPL"] = "pallas" if name == "mixed" else "jnp"
    cfg = dataclasses.replace(
        sp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=n), **over)
    m = mesh(n)
    params = sp.init_pipeline_params(jax.random.PRNGKey(0), cfg, n)
    flat(params, name + "/params/")
    tok, lab = batch(cfg, 1)
    with m:
        loss, wb = jax.jit(sp.build_pipeline_step(
            cfg, m, sc, N_MICRO, MB, SEQ, bwd_qcfg=bwd))(params, tok, lab)
        gl, grads, gwb = jax.jit(sp.build_pipeline_grad_step(
            cfg, m, sc, bwd, N_MICRO, MB, SEQ))(params, tok, lab)
    for k, v in (("loss", loss), ("wire", wb), ("grad_loss", gl),
                 ("grad_wire", gwb)):
        res[name + "/" + k] = np.asarray(v)
    flat(grads, name + "/grads/")
os.environ["REPRO_QUANT_IMPL"] = "jnp"

# 4 AdamW steps, the static wire and the adaptive one
cfg = sp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=2)
batches = [batch(cfg, 10 + i) for i in range(4)]
opt = AdamWConfig(lr={lr}, eps={eps}, weight_decay=0.0)
for name, kw in (("train", {{}}),
                 ("adaptive", dict(wire_budget_bytes={budget},
                                   plan_groups=8))):
    log = []
    _, _, hist, wb = sp.train_pipeline(
        cfg, mesh(2), split(2), opt, iter(batches), n_micro=N_MICRO,
        micro_batch=MB, seq=SEQ, plan_log=log, **kw)
    res[name + "/history"] = np.asarray(hist)
    res[name + "/wire"] = np.asarray(wb)
    res[name + "/plan_steps"] = np.asarray([s for s, _ in log], np.int64)
    res[name + "/plans"] = np.asarray([p for _, p in log], np.int64)
np.savez(sys.argv[1], **res)
"""
BUDGET = MB * SEQ * 256 * 2 / 8  # 2 bits of code a scalar, one shipment
# The histories' AdamW.  Adam's first update of a weight is
# lr g / (|g| + eps): where g is at rounding level (~1e-8), its size and sign
# follow the order of summation, which JAX and PyTorch do not share, so with
# the default eps 1e-8 a handful of weights move up to lr apart (measured:
# 4 of 1.3 M after one step, 2.5e-4 apart at lr 5e-3), and once one of them
# moves a 2-bit code across a threshold at the cut the losses part (step 4
# by 4e-4 at lr 5e-3 or 3e-4, 2.8e-4 at 1e-3).  With eps 1e-6 those weights
# take no step and the histories agree to 7e-8 (lr 1e-3).
TRAIN_LR, TRAIN_EPS = 1e-3, 1e-6
CASES = {"two": ({}, 2, None), "two_bwd": ({}, 2, "r2"),
         "mixed": ({}, 4, None), "g2": ({"n_kv_heads": 2}, 2, None)}


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
    """Starts the reference's runs (about a minute on the CPU) with the
    module's first test, so that the tests before ``ref`` overlap them."""
    path = tmp_path_factory.mktemp("split_pipeline") / "ref.npz"
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
    """The reference's losses, gradients, wire bytes and 4-step histories."""
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


def _case(name):
    over, n, bwd = CASES[name]
    cfg = dataclasses.replace(
        tsp._homogeneous_cfg("llama3_2_3b", reduced=True, n_stages=n),
        **over)
    r2 = TQC(method="rdfsq", bits=2)
    quants = (r2, TQC(method="nf", bits=4), r2) if name == "mixed" else ()
    split = tsplit.SplitConfig(quant=r2, learnable_codec=False, n_stages=n,
                               stage_quants=quants)
    return cfg, split, r2 if bwd else None


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size,
                       (N_MICRO, MB, SEQ)).astype(np.int32)
    lab = np.concatenate(
        [tok[..., 1:], np.full((N_MICRO, MB, 1), -100, np.int32)], -1)
    return torch.as_tensor(tok), torch.as_tensor(lab)


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_loss_matches_reference(ref, name):
    """``build_pipeline_step``'s loss within LOSS_RTOL and its per-tick
    wire bytes exactly; the transport counts ``n_micro`` payloads a link,
    each ``fwd_wire_bytes``."""
    cfg, split, bwd = _case(name)
    params = from_jax_params(_unflatten(ref, name + "/params/"), "cpu")
    step = tsp.build_pipeline_step(cfg, split, N_MICRO, MB, SEQ,
                                   bwd_qcfg=bwd)
    loss, wire = step(params, *_batch(cfg, 1))
    np.testing.assert_allclose(float(loss), ref[name + "/loss"],
                               rtol=LOSS_RTOL)
    assert wire == float(ref[name + "/wire"])
    table = tsp.pipeline_wire_bytes(cfg, split, MB, SEQ, bwd)
    assert dict(step.transport.bytes) == {
        link: entry["fwd"] * N_MICRO for link, entry in
        table["links"].items()}
    assert set(step.transport.payloads.values()) == {N_MICRO}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_grads_match_reference(ref, name):
    """``build_pipeline_grad_step``: the loss within LOSS_RTOL, every
    gradient leaf at cosine >= GRAD_COS, the wire bytes exactly; both
    directions of every link counted as ``n_micro`` payloads."""
    cfg, split, bwd = _case(name)
    params = from_jax_params(_unflatten(ref, name + "/params/"), "cpu")
    grad_step = tsp.build_pipeline_grad_step(cfg, split, bwd, N_MICRO, MB,
                                             SEQ)
    loss, grads, wire = grad_step(params, *_batch(cfg, 1))
    np.testing.assert_allclose(float(loss), ref[name + "/grad_loss"],
                               rtol=LOSS_RTOL)
    assert wire == float(ref[name + "/grad_wire"])
    jgrads = _unflatten(ref, name + "/grads/")
    ours = dict(tree_flatten_with_path(grads))
    theirs = {tuple(k.split("/")): v for k, v in
              ((k[len(name + "/grads/"):], v) for k, v in ref.items()
               if k.startswith(name + "/grads/"))}
    assert set(ours) == set(theirs) and jgrads
    cos = {k: _cos(ours[k].numpy(), theirs[k]) for k in theirs}
    assert min(cos.values()) >= GRAD_COS, cos
    table = tsp.pipeline_wire_bytes(cfg, split, MB, SEQ, bwd)
    expect = {}
    for (src, dst), entry in table["links"].items():
        expect[(src, dst)] = entry["fwd"] * N_MICRO
        expect[(dst, src)] = entry["bwd"] * N_MICRO
    assert dict(grad_step.transport.bytes) == expect


def _train(ref, name, **kw):
    cfg, split, _ = _case("two")
    params = from_jax_params(_unflatten(ref, "two/params/"), "cpu")
    batches = [_batch(cfg, 10 + i) for i in range(4)]
    log = []
    _, _, hist, wire = tsp.train_pipeline(
        cfg, split,
        tsp.AdamWConfig(lr=TRAIN_LR, eps=TRAIN_EPS, weight_decay=0.0),
        batches, n_micro=N_MICRO, micro_batch=MB, seq=SEQ, params=params,
        plan_log=log, **kw)
    np.testing.assert_allclose(hist, ref[name + "/history"],
                               rtol=LOSS_RTOL)
    assert wire == float(ref[name + "/wire"])
    return log


def test_train_pipeline_history_matches_reference(ref):
    """Four AdamW steps (TRAIN_LR, TRAIN_EPS) over the 2-bit pipeline: the loss
    history within LOSS_RTOL a step (the reference draws its parameters
    from the same key, so both start from one point)."""
    assert _train(ref, "train") == []


def test_adaptive_plan_log_matches_reference(ref):
    """The adaptive re-plan (probe, EMA entropy, ``replan_widths``): the
    same ``plan_log`` and the loss history within LOSS_RTOL."""
    log = _train(ref, "adaptive", wire_budget_bytes=BUDGET, plan_groups=8)
    assert [s for s, _ in log] == list(ref["adaptive/plan_steps"])
    assert [list(p) for _, p in log] == ref["adaptive/plans"].tolist()
    assert log


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

def test_pipeline_equals_monolithic_composition():
    """The 2-stage pipeline's loss is the monolithic composition's (embed,
    stage 0's blocks, the cut's codec roundtrip, stage 1's blocks, head +
    CE), microbatch by microbatch: the check ``chip_smoke.py`` makes on
    the card."""
    from repro_torch.core import quantizers

    cfg, split, _ = _case("two")
    params = init_stage_params(cfg, 2, seed=5, device="cpu")
    tokens, labels = _batch(cfg, 6)
    loss, _ = tsp.build_pipeline_step(cfg, split, N_MICRO, MB, SEQ)(
        params, tokens, labels)
    pos = torch.arange(SEQ, dtype=torch.int32)
    total = 0.0
    for j in range(N_MICRO):
        x = embed_tokens(cfg, params, tokens[j])
        x = run_blocks(cfg, stage_blocks(params, 0), x, pos)
        x = quantizers.decode(split.quant, quantizers.encode(split.quant, x))
        x = run_blocks(cfg, stage_blocks(params, 1), x, pos)
        total = total + head_ce(cfg, params, x, labels[j])
    assert float(loss) == pytest.approx(float(total / N_MICRO), rel=1e-6)


def test_train_pipeline_falls_and_counts_both_directions():
    """A few steps on the reduced config from the port's own seed: the loss
    falls and the transport counts the forward and cotangent payloads of
    every step."""
    cfg, split, _ = _case("two")
    bwd = TQC(method="rdfsq", bits=2)
    transport = tsplit.Transport()
    batches = tsp.make_batches(cfg, 6, N_MICRO, MB, 32)
    _, opt, hist, wire = tsp.train_pipeline(
        cfg, split, tsp.AdamWConfig(lr=5e-3, weight_decay=0.0), batches,
        n_micro=N_MICRO, micro_batch=MB, seq=32, bwd_qcfg=bwd,
        device="cpu", transport=transport)
    assert hist[-1] < hist[0]
    table = tsp.pipeline_wire_bytes(cfg, split, MB, 32, bwd)["links"][(0, 1)]
    assert transport.bytes == {(0, 1): table["fwd"] * 6 * N_MICRO,
                               (1, 0): table["bwd"] * 6 * N_MICRO}
    assert wire == table["fwd"] + table["bwd"] and int(opt["step"]) == 6


def test_boundary_probe_is_stage_blocks_on_the_embedding():
    cfg, _, _ = _case("two")
    params = init_stage_params(cfg, 2, seed=1, device="cpu")
    tokens = _batch(cfg, 2)[0][0]
    h = tsched.boundary_probe(cfg, params, tokens, stage=1)
    x = embed_tokens(cfg, params, tokens)
    want = run_blocks(cfg, stage_blocks(params, 1), x,
                      torch.arange(SEQ, dtype=torch.int32))
    assert torch.equal(h, want) and not h.requires_grad


def test_entry_point_runs_on_the_cpu(capsys):
    assert tsp.main(["--device", "cpu", "--reduced", "--steps", "2",
                     "--n-micro", "2", "--micro-batch", "2", "--seq", "16",
                     "--bwd-bits", "2"]) == 0
    out = capsys.readouterr().out
    assert "counted" in out and "loss" in out
