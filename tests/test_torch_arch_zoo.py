"""The dense GQA configs (``granite_3_8b``, ``deepseek_coder_33b``,
``llava_next_34b``), ``minicpm3_4b`` (MLA), ``arctic_480b`` (MoE blocks)
and ``deepseek_v2_236b`` (a dense block, then MoE blocks, with MLA) in
the port against the JAX reference, on the CPU, in fp32 at
``reduced()``: the configs field for field, their segments and cut, the
registry's aliases and refusals, the parameter trees and their crossing
by ``from_jax_params``, the forward's logits and caches, one training
step's loss and gradients, a decode step, greedy ``generate`` token for
token, granite's odd vocab, the engine refusing MLA where the reference's
does and serving the rest; and ``leaf_makers`` drawing the weights it drew
before it scaled in place."""
import pytest

pytest.importorskip("jax")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import decode as jsd  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train.losses import composite_loss as jloss  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

ARCHS = ["granite_3_8b", "deepseek_coder_33b", "llava_next_34b",
         "minicpm3_4b", "arctic_480b", "deepseek_v2_236b"]
# the configs the paged engine serves (MLA has no paged form)
GQA_ARCHS = [a for a in ARCHS if tget(a).attn_type != "mla"]
# the tolerances of tests/test_torch_model.py (tinyllava): logits and
# caches 1e-5, a decode step 1e-4; a training step's as
# tests/test_torch_train.py's
ATOL, DECODE_ATOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(0)


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
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference cfg, port cfg, reference params, port params) at
    ``reduced()``, the port's crossed by ``from_jax_params``."""
    cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    jp = jtf.init_params(KEY, cfg)
    return cfg, tcfg, jp, from_jax_params(jp, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_prefill(cfg):
    """The reference's forward with its caches collected into a ring of 40
    slots, jitted (its op-by-op dispatch costs seconds a call)."""
    return jax.jit(functools.partial(jtf.forward, cfg=cfg, collect_cache=40))


def _prompts(cfg, b=2, plen=9, seed=11):
    """(reference batch, port batch): tokens, and image embeddings for a
    vlm config."""
    rng = np.random.default_rng(seed)
    batch = dict(tokens=rng.integers(1, cfg.vocab_size, (b, plen))
                 .astype(np.int32))
    if cfg.modality == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    """``dataclasses.asdict``, block pattern, segments and the cut of the
    full and the reduced configs equal the reference's."""
    ref, port = get_config(arch), tget(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.block_pattern() == ref.block_pattern()
    assert port.segments() == ref.segments()
    assert port.client_server_segments() == ref.client_server_segments()
    assert port.split.resolve_cut(port.n_layers) == \
        ref.split.resolve_cut(ref.n_layers)


def test_full_configs_keep_their_published_shapes():
    """The widths the card runs: G 4 / 7 / 7 at head width 128, MLA's (96,
    64) at 40 heads, the cuts at layers 20 / 31 / 0 / 31."""
    shapes = {a: (c.n_heads // c.n_kv_heads, c.head_dim,
                  c.split.resolve_cut(c.n_layers))
              for a in ARCHS[:3] for c in [tget(a)]}
    assert shapes == {"granite_3_8b": (4, 128, 20),
                      "deepseek_coder_33b": (7, 128, 31),
                      "llava_next_34b": (7, 128, 0)}
    m = tget("minicpm3_4b")
    assert (m.attn_type, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim,
            m.n_heads, m.split.resolve_cut(m.n_layers)) == \
        ("mla", 96, 64, 40, 31)
    assert tget("granite_3_8b").vocab_size % 2 == 1


@pytest.mark.parametrize("alias,arch", [
    ("granite-3-8b", "granite_3_8b"),
    ("deepseek-coder-33b", "deepseek_coder_33b"),
    ("llava-next-34b", "llava_next_34b"),
    ("minicpm3-4b", "minicpm3_4b"),
    ("llama3.2-3b", "llama3_2_3b"),
    ("llama3-2-3b", "llama3_2_3b"),
    ("arctic-480b", "arctic_480b"),
    ("deepseek-v2-236b", "deepseek_v2_236b"),
    ("zamba2-2.7b", "zamba2_2_7b"),
    ("rwkv6-7b", "rwkv6_7b"),
    ("musicgen-large", "musicgen_large")])
def test_aliases_resolve_as_the_reference_s(alias, arch):
    assert tget(alias) is tget(arch)
    assert dataclasses.asdict(tget(alias)) == \
        dataclasses.asdict(get_config(alias))


@pytest.mark.parametrize("arch", ["no_such_arch"])
def test_unported_archs_raise_naming_their_item(arch):
    """Every arch of the reference's is ported: only a name the reference
    does not know raises, naming itself."""
    with pytest.raises(KeyError, match=f"unknown arch '{arch}'"):
        tget(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_bridge_match_reference_tree(arch):
    """The port's ``init_params`` gives the reference's tree, key for key
    and shape for shape (MLA's wq_a / q_norm / wq_b / wkv_a / kv_norm /
    wkv_b / wo), and ``from_jax_params`` carries the reference's tree
    across unchanged, leaf for leaf."""
    _, tcfg, jp, tp = _setup(arch)
    port = ttf.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(port) == _shapes(jp) == _shapes(tp)
    for (path, a), (_, b) in zip(tree_flatten_with_path(tp),
                                 tree_flatten_with_path(port)):
        assert a.dtype == b.dtype == torch.float32, path
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for p, leaf in flat:
        node = tp
        for k in p:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def _leaf_makers_scaling_a_copy(cfg, seed, device):
    """``leaf_makers`` as it was before it scaled in place: each leaf drawn
    in fp32, then ``x * scale`` as a second fp32 tensor, then cast."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = ttf.pdtype(cfg)

    def normal(*shape, scale):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return normal, const, gen, torch.device(device)


@pytest.mark.parametrize("arch,dtype", [
    ("tinyllava", "bfloat16"), ("llama3_2_3b", "float32"),
    ("minicpm3_4b", "bfloat16"), ("granite_3_8b", "float32")])
def test_leaf_makers_scale_in_place_to_the_same_weights(arch, dtype,
                                                        monkeypatch):
    """Scaling each drawn leaf in place (``x.mul_(scale)``, no second fp32
    tensor) gives every dense config the weights it had, bit for bit: the
    reduced configs in the parameter dtype given."""
    cfg = dataclasses.replace(tget(arch).reduced(), param_dtype=dtype)
    new = ttf.init_params(cfg, seed=3, device="cpu")
    monkeypatch.setattr(ttf, "leaf_makers", _leaf_makers_scaling_a_copy)
    old = ttf.init_params(cfg, seed=3, device="cpu")
    flat_new, flat_old = (tree_flatten_with_path(t) for t in (new, old))
    assert [p for p, _ in flat_new] == [p for p, _ in flat_old]
    for (path, a), (_, b) in zip(flat_new, flat_old):
        assert a.dtype == b.dtype == ttf.DTYPES[dtype], path
        assert torch.equal(a, b), path


def test_moe_leaves_draw_one_expert_at_a_time():
    """A moe config's stacked experts are drawn one (d, f) slice at a time
    into a leaf of the parameter dtype, with the reference's scales; the
    router is fp32 in a bf16 config, as the reference keeps it."""
    cfg = dataclasses.replace(tget("arctic_480b").reduced(),
                              param_dtype="bfloat16")
    p = ttf.init_params(cfg, seed=0, device="cpu")["server"]["seg0"]["ffn"]
    d, f = cfg.d_model, cfg.moe_d_ff
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (1, cfg.n_experts, d, f)
    assert p["w_gate"].dtype == p["dense_residual"]["w_up"].dtype \
        == torch.bfloat16
    for name, scale in (("w_gate", d ** -0.5), ("w_down", f ** -0.5)):
        std = p[name].float().std(dim=(-2, -1))
        np.testing.assert_allclose(std.numpy(), scale, rtol=0.05)
    # the experts are different draws
    assert not torch.equal(p["w_up"][0, 0], p["w_up"][0, 1])


# ---------------------------------------------------------------------------
# forward, training step, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_caches_match_reference(arch):
    """Logits, the commitment loss and every layer's cache (GQA: k, v,
    pos; MLA: the latent ckv, krope, pos) of a prefill into a ring of
    40 slots."""
    cfg, tcfg, jp, tp = _setup(arch)
    jb, tb = _prompts(cfg)
    jl, jaux, jc = _jax_prefill(cfg)(jp, batch=jb)
    tl, taux, tc = ttf.forward(tp, tcfg, tb, collect_cache=40)
    _close(tl, jl)
    _close(taux["commit"], jaux["commit"], atol=1e-6)
    for side in ("client", "server"):
        jseg, tseg = jc[side]["seg0"], tc[side]["seg0"]
        assert tseg.keys() == jseg.keys()
        for leaf in tseg:
            if leaf == "pos":
                np.testing.assert_array_equal(tseg[leaf].numpy(),
                                              np.asarray(jseg[leaf]))
            else:
                _close(tseg[leaf], jseg[leaf])


def _jax_step(cfg, jp, batch):
    alpha = cfg.split.quant.commit_alpha

    def loss_fn(params):
        logits, aux = jtf.forward(params, cfg, batch, rng=KEY)
        return jloss(logits, batch, aux, alpha)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    return jm, jg


def _leaves(tree):
    if any(isinstance(x, torch.Tensor)
           for _, x in tree_flatten_with_path(tree)):
        return {"/".join(p): x.detach().float().numpy()
                for p, x in tree_flatten_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(x, np.float32)
            for p, x in flat}


def _check_step(cfg, tcfg, jp, tp, batch):
    """loss / ce / commit within rtol 1e-5, every gradient leaf within 1e-4
    of its max |leaf| plus 1e-6 (tests/test_torch_train.py's tolerances:
    fp32 sums in another order)."""
    jm, jg = _jax_step(cfg, jp, batch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(arch):
    """One training step's composite loss and every gradient leaf (MLA:
    through the plain K2 / K3 at q/k 32, v 16) on a batch of the data
    pipeline, 2 x 24 text positions (plus the image tokens of a vlm)."""
    cfg, tcfg, jp, tp = _setup(arch)
    batch = next(jpipeline(cfg, 2, 24 + cfg.n_image_tokens, seed=0))
    _check_step(cfg, tcfg, jp, tp, batch)


def test_odd_vocab_forward_and_step_match_reference():
    """granite_3_8b's vocab of 49 155 (odd: embedding and head rows of an
    odd length) at reduced widths otherwise: the forward's logits and one
    training step's loss and gradients."""
    cfg = dataclasses.replace(get_config("granite_3_8b").reduced(),
                              vocab_size=49155)
    tcfg = dataclasses.replace(tget("granite_3_8b").reduced(),
                               vocab_size=49155)
    jp = jtf.init_params(KEY, cfg)
    tp = from_jax_params(jp, "cpu")
    batch = next(jpipeline(cfg, 2, 16, seed=3))
    assert int(batch["tokens"].max()) < cfg.vocab_size
    jl, _ = jax.jit(functools.partial(jtf.forward, cfg=cfg))(
        jp, batch={k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = ttf.forward(tp, tcfg, tloop.batch_to(batch, torch.device("cpu")))
    assert tl.shape[-1] == 49155
    _close(tl, jl)
    _check_step(cfg, tcfg, jp, tp, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """Three one-token steps after a prefill into a ring of 40 slots (MLA:
    the absorbed-weight step over the latent cache): logits within 1e-4,
    the caches within 1e-5."""
    cfg, tcfg, jp, tp = _setup(arch)
    jb, tb = _prompts(cfg)
    _, _, jc = _jax_prefill(cfg)(jp, batch=jb)
    _, _, tc = ttf.forward(tp, tcfg, tb, collect_cache=40)
    step = jax.jit(functools.partial(jtf.decode_step, cfg=cfg))
    n = jb["tokens"].shape[1] + cfg.n_image_tokens
    rng = np.random.default_rng(4)
    for i in range(3):
        toks = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        qpos = np.full((2,), n + i, np.int32)
        jl, jc = step(jp, caches=jc, batch=dict(tokens=jnp.asarray(toks)),
                      qpos=jnp.asarray(qpos))
        tl, tc = ttf.decode_step(tp, tcfg, tc, dict(tokens=_t(toks)),
                                 _t(qpos))
        _close(tl, jl, atol=DECODE_ATOL)
    for side in ("client", "server"):
        for leaf, val in tc[side]["seg0"].items():
            if leaf == "pos":
                np.testing.assert_array_equal(
                    val.numpy(), np.asarray(jc[side]["seg0"][leaf]))
            else:
                _close(val, jc[side]["seg0"][leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_token_exact_vs_reference(arch):
    """Greedy ``generate``, prefill included, 8 new tokens, token for token
    against the reference's (a ring of 40 slots)."""
    cfg, tcfg, jp, tp = _setup(arch)
    jb, tb = _prompts(cfg, b=3, seed=12)
    ref = np.asarray(jsd.generate(jp, cfg, jb, n_new=8, cache_len=40))
    out = tsd.generate(tp, tcfg, tb, n_new=8, cache_len=40).numpy()
    assert out.shape == (3, 8)
    np.testing.assert_array_equal(out, ref)


def test_engine_refuses_mla_as_the_reference_does():
    """The paged engine needs GQA KV pools: for minicpm3_4b both engines
    raise ``NotImplementedError`` from their pool constructors, and so do
    the port's ``init_paged_caches`` and a paged block step."""
    cfg, tcfg, jp, tp = _setup("minicpm3_4b")
    kw = dict(n_slots=2, page_size=4, n_pages=9)
    with pytest.raises(NotImplementedError) as ref:
        JEngine(jp, cfg, **kw)
    with pytest.raises(NotImplementedError) as port:
        TEngine(tp, tcfg, device="cpu", **kw)
    assert str(port.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="GQA"):
        ttf.init_paged_caches(tcfg, 9, 4, device="cpu")
    p = {k: v[0] for k, v in tp["server"]["seg0"].items()
         if not isinstance(v, dict)}
    p["attn"] = {k: v[0] for k, v in tp["server"]["seg0"]["attn"].items()}
    with pytest.raises(NotImplementedError, match="paged decode"):
        ttf.block_decode(tcfg, p, torch.zeros(1, 1, tcfg.d_model), {},
                         qpos=torch.zeros(1, dtype=torch.int32), window=None,
                         page_table=torch.zeros(1, 1, dtype=torch.int32))


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_engine_serves_gqa_zoo_on_the_cpu(arch):
    """The GQA configs (arctic's MoE blocks among them) through the port's
    ``ServeEngine`` on the CPU (their 2-bit wire at the cut, paged pools):
    every request finishes with its budget of in-vocab tokens and the
    pages return."""
    _, tcfg, _, tp = _setup(arch)
    eng = TEngine(tp, tcfg, n_slots=2, page_size=4, n_pages=40,
                  device="cpu")
    rng = np.random.default_rng(5)
    rids = []
    for i in range(3):
        img = None if tcfg.modality != "vlm" else _t(rng.normal(
            size=(tcfg.n_image_tokens, tcfg.d_vision)).astype(np.float32))
        toks = rng.integers(1, tcfg.vocab_size, 5 + i).tolist()
        rids.append(eng.submit(toks, max_new=4, image_embeds=img))
    eng.run()
    for rid in rids:
        r = eng.request(rid)
        assert r.state == "done" and len(r.out) == 4
        assert all(0 <= t < tcfg.vocab_size for t in r.out)
    assert eng.page_pool.n_live == 0
