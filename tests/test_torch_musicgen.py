"""musicgen_large in the port (the audio modality: one embedding table a
EnCodec codebook, summed, and one head a codebook) against the JAX
reference, on the CPU, from the same numpy inputs and the reference's own
parameters (crossed with ``from_jax_params``), at ``reduced()`` (2
codebooks, 4 / 4 heads of 64: G 1): the codebook embedding and the 3-D
head bit for bit in bf16, the config, the tree and the bridge, the
forward's (B, S, K, V) logits and ring caches, the audio
``composite_loss``, a training step's loss and gradients, decode steps
over bf16 and int8 rings, greedy ``generate`` token for token with and
without EOS, checkpoints of a training state both ways, the engine's
refusal, the launchers, and the K1 - K3 and K6 / K7 launch plans at
musicgen's full shapes (head width 64, G 1)."""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import embedding as jemb  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.serve import decode as jsd  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.losses import composite_loss as jloss  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import embedding as temb  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.losses import composite_loss  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

# fp32 on both sides, sums in another order: logits, losses and caches
# within ATOL of max(1, max |ref|), a decode step's logits within
# DECODE_ATOL (as tests/test_torch_arch_zoo.py); a training step's loss
# rtol 1e-5, each gradient leaf 1e-4 of its max |leaf| plus 1e-6 (as
# tests/test_torch_train.py); int8 codes within one step
ATOL, DECODE_ATOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(0)
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


@functools.lru_cache(maxsize=None)
def _setup(**upd):
    """(reference cfg, port cfg, reference params, port params) at
    ``reduced()`` with ``upd``."""
    cfg = dataclasses.replace(get_config("musicgen_large").reduced(), **upd)
    tcfg = dataclasses.replace(tget("musicgen_large").reduced(), **upd)
    jp = jtf.init_params(KEY, cfg)
    return cfg, tcfg, jp, from_jax_params(jp, "cpu")


def _prompts(cfg, b=2, plen=9, seed=11):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, cfg.vocab_size,
                         (b, cfg.n_codebooks, plen)).astype(np.int32)
    return dict(codes=jnp.asarray(codes)), dict(codes=_t(codes))


def _leaves(tree):
    """{path: fp32 numpy leaf} of a port tree or a reference tree."""
    if any(isinstance(x, torch.Tensor)
           for _, x in tree_flatten_with_path(tree)):
        return {"/".join(p): x.detach().float().numpy()
                for p, x in tree_flatten_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in p): np.asarray(x, np.float32)
            for p, x in flat}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _close_caches(tc, jc, atol=ATOL):
    """Every ring-cache leaf: k, v, pos; int8 codes within one step (a code
    may move by one where the absmax scaling rounds at a half)."""
    tl = dict(tree_flatten_with_path(tc))
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    jl = {tuple(str(k.key) for k in p): x for p, x in flat}
    assert tl.keys() == jl.keys()
    for path, j in jl.items():
        t = tl[path]
        assert tuple(t.shape) == j.shape, path
        if t.dtype in (torch.int32, torch.int8):
            diff = np.abs(t.numpy().astype(np.int32)
                          - np.asarray(j).astype(np.int32))
            assert diff.max() <= (0 if path[-1] == "pos" else 1), path
        else:
            _close(t, j, atol)


# ---------------------------------------------------------------------------
# the audio embedding and head
# ---------------------------------------------------------------------------

def test_codebook_embedding_and_head_bitwise_in_bf16():
    """``embed_codebooks`` (4 tables summed in codebook order, from the
    reference's Python ``sum``) and the 3-D head's ``bsd,kdv->bskv`` give
    the reference's bits in bf16."""
    rng = np.random.default_rng(3)
    emb = (rng.normal(size=(4, 64, 32)) * 0.02).astype(np.float32)
    w = (rng.normal(size=(4, 32, 64)) * 32 ** -0.5).astype(np.float32)
    codes = rng.integers(0, 64, (2, 4, 7)).astype(np.int32)
    jx = jemb.embed_codebooks(dict(emb=jnp.asarray(emb)), jnp.asarray(codes),
                              jnp.bfloat16)
    tx = temb.embed_codebooks(dict(emb=_t(emb)), _t(codes), torch.bfloat16)
    assert tx.dtype == torch.bfloat16 and tuple(tx.shape) == (2, 7, 32)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32))
    jl = jemb.head_logits(dict(w=jnp.asarray(w)), jx)
    tl = temb.head_logits(dict(w=_t(w)), tx)
    assert tuple(tl.shape) == (2, 7, 4, 64) and tl.dtype == torch.bfloat16
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl, np.float32))


# ---------------------------------------------------------------------------
# config, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "reduced"])
def test_config_and_segments_match_reference(kind):
    """``dataclasses.asdict`` and the segments of the full and reduced
    configs equal the reference's; the alias names the same config."""
    ref, port = get_config("musicgen_large"), tget("musicgen_large")
    assert tget("musicgen-large") is port
    if kind == "reduced":
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.client_server_segments() == ref.client_server_segments()


def test_full_config_keeps_its_published_shapes():
    """48 dense layers cut at 24, d 2 048, 32 / 32 heads of 64 (G 1), 4
    codebooks of 2 048."""
    cfg = tget("musicgen_large")
    assert cfg.client_server_segments() == ((("dense", 24),),
                                            (("dense", 24),))
    assert (cfg.modality, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.n_codebooks, cfg.vocab_size) == ("audio", 32, 32, 64, 4,
                                                 2048)


def test_init_params_and_bridge_match_reference_tree():
    """The port's ``init_params`` gives the reference's tree key for key
    and shape for shape (the (K, V, d) embedding, the (K, d, V) head, no
    connector), and ``from_jax_params`` carries it across leaf for leaf."""
    _, tcfg, jp, tp = _setup()
    port = ttf.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(port) == _shapes(jp) == _shapes(tp)
    assert tuple(port["embed"]["emb"].shape) == (2, 512, 256)
    assert tuple(port["head"]["w"].shape) == (2, 256, 512)
    assert "connector" not in port
    assert abs(float(port["head"]["w"].std()) * 256 ** 0.5 - 1) < 0.05
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])


# ---------------------------------------------------------------------------
# forward, loss, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 8])
def test_forward_logits_and_caches_match_reference(bits):
    """(B, S, K, V) logits, the commitment loss and the collected ring
    caches (16-bit or int8) of a prefill of 2 x 9 frames into a ring of
    40."""
    cfg, tcfg, jp, tp = _setup(kv_cache_bits=bits)
    jb, tb = _prompts(cfg)
    jl, jaux, jc = jax.jit(functools.partial(jtf.forward, cfg=cfg,
                                             collect_cache=CACHE))(
        jp, batch=jb)
    tl, taux, tc = ttf.forward(tp, tcfg, tb, collect_cache=CACHE)
    assert tuple(tl.shape) == (2, 9, 2, 512)
    _close(tl, jl)
    _close(taux["commit"], jaux["commit"])
    _close_caches(tc, jc)


def test_composite_loss_audio_layout_matches_reference():
    """``labels_codes`` (B, K, S) transposed to (B, S, K) against logits
    (B, S, K, V), IGNORE masked: the loss and its metrics."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 5, 3, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 3, 5)).astype(np.int32)
    labels[:, :, -1] = -100
    aux = dict(commit=np.float32(0.3), load_balance=np.float32(0.0),
               router_z=np.float32(0.0), drop_fraction=np.float32(0.0))
    jv, jm = jloss(jnp.asarray(logits), dict(labels_codes=jnp.asarray(
        labels)), {k: jnp.asarray(v) for k, v in aux.items()}, 0.25)
    tv, tm = composite_loss(_t(logits), dict(labels_codes=_t(labels)),
                            {k: torch.tensor(v) for k, v in aux.items()},
                            0.25)
    _close(tv, jv)
    for k in ("ce", "commit"):
        _close(tm[k], jm[k])


def test_train_step_loss_and_grads_match_reference():
    """One training step's composite loss and every gradient leaf against
    ``jax.grad`` on an audio batch of the data pipeline (2 x 24 frames of
    2 codebooks), the 2-bit cut in the graph."""
    cfg, tcfg, jp, tp = _setup()
    batch = next(jpipeline(cfg, 2, 24, seed=0))
    assert set(batch) == {"codes", "labels_codes", "positions"}
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
    assert float(np.abs(tl["embed/emb"][1]).max()) > 0  # both codebooks


def test_donated_train_step_matches_the_copying_one():
    """``make_train_step(donate=True)`` updates the state in place and
    gives the copying step's parameters, moments and metrics bit for bit
    over two steps."""
    _, tcfg, _, _ = _setup()
    opt = AdamWConfig(lr=1e-3)
    data = list(zip(range(2), tpipeline(tcfg, 2, 16, seed=1)))
    states = [tloop.init_state(tcfg, opt, seed=2, device="cpu")
              for _ in range(2)]
    outs = []
    for state, donate in zip(states, (False, True)):
        step = tloop.make_train_step(tcfg, opt, total_steps=2,
                                     warmup_steps=1, donate=donate)
        first = state.params["head"]["w"]
        for _, b in data:
            state, m = step(state, b)
        assert (state.params["head"]["w"] is first) == donate
        outs.append((state, m))
    (a, ma), (b, mb) = outs
    for (p, x), (_, y) in zip(tree_flatten_with_path(a.params)
                              + tree_flatten_with_path(a.opt),
                              tree_flatten_with_path(b.params)
                              + tree_flatten_with_path(b.opt)):
        assert torch.equal(x, y), p
    assert {k: float(v) for k, v in ma.items()} == \
        {k: float(v) for k, v in mb.items()}


def test_layer_forward_count_is_twice_a_layer_under_remat():
    """K1 runs twice a layer a training step at full depth under remat
    (48 layers in two segments of 24, stored inputs far below the remat
    budget: single-level), once without."""
    cfg = tget("musicgen_large")
    x = torch.empty((2, 1024, 2048), dtype=torch.bfloat16, device="meta")
    assert ttf.layer_forward_count(cfg, x) == 96
    assert ttf.layer_forward_count(
        dataclasses.replace(cfg, remat=False), x) == 48


# ---------------------------------------------------------------------------
# decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 8])
def test_decode_steps_match_reference(bits):
    """Four one-frame steps (``codes`` (B, K, 1)) after the prefill over
    bf16-width or int8 rings: (B, 1, K, V) logits within DECODE_ATOL, then
    every cache."""
    cfg, tcfg, jp, tp = _setup(kv_cache_bits=bits)
    jb, tb = _prompts(cfg)
    _, _, jc = jtf.forward(jp, cfg, jb, collect_cache=CACHE)
    _, _, tc = ttf.forward(tp, tcfg, tb, collect_cache=CACHE)
    step = jax.jit(functools.partial(jtf.decode_step, cfg=cfg))
    rng = np.random.default_rng(4)
    for i in range(4):
        codes = rng.integers(1, cfg.vocab_size,
                             (2, cfg.n_codebooks, 1)).astype(np.int32)
        qpos = np.full((2,), 9 + i, np.int32)
        jl, jc = step(jp, caches=jc, batch=dict(codes=jnp.asarray(codes)),
                      qpos=jnp.asarray(qpos))
        tl, tc = ttf.decode_step(tp, tcfg, tc, dict(codes=_t(codes)),
                                 _t(qpos))
        assert tuple(tl.shape) == (2, 1, 2, 512)
        _close(tl, jl, DECODE_ATOL)
    _close_caches(tc, jc, DECODE_ATOL)


@pytest.mark.parametrize("eos", [None, 1], ids=["no_eos", "eos"])
def test_generate_token_exact_vs_reference(eos):
    """Greedy ``generate``, prefill included, 8 new frames of (B, K) codes
    ((B, n_new, K) out), code for code against the reference's.  With EOS
    (a config of 3 codes, so that whole frames of EOS come): a row is done
    when every codebook emits it, and is padded after."""
    upd = {} if eos is None else dict(vocab_size=3)
    cfg, tcfg, jp, tp = _setup(**upd)
    jb, tb = _prompts(cfg, b=4, seed=12)
    ref = np.asarray(jsd.generate(jp, cfg, jb, n_new=8, cache_len=CACHE,
                                  eos_id=eos))
    out = tsd.generate(tp, tcfg, tb, n_new=8, cache_len=CACHE,
                       eos_id=eos).numpy()
    assert out.shape == (4, 8, 2)
    np.testing.assert_array_equal(out, ref)
    if eos is not None:
        frames = (out == eos).all(axis=-1)
        assert frames.any()
        for row, hit in zip(out, frames):
            if hit.any():  # padded after its first all-EOS frame
                assert (row[int(np.argmax(hit)) + 1:] == 0).all()


# ---------------------------------------------------------------------------
# checkpoints, refusals, launchers, plans
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """The reference's test_train_serve.py::test_checkpoint_roundtrip on
    the port (a musicgen training state saved and restored into a template
    of another seed, leaf for leaf), and the reference's saved state
    restored into the port's."""
    cfg, tcfg, _, _ = _setup()
    state = tloop.init_state(tcfg, AdamWConfig(), seed=0, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(path, state)
    template = tloop.init_state(tcfg, AdamWConfig(), seed=1, device="cpu")
    restored = tckpt.restore(path, template)
    for (p, a), (_, b) in zip(
            tree_flatten_with_path(dataclasses.asdict(state)),
            tree_flatten_with_path(dataclasses.asdict(restored))):
        assert torch.equal(a, b), p
    jstate = jloop.init_state(KEY, cfg, JAdamW())
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jstate)
    restored = tckpt.restore(jpath, template)
    jl = _leaves(jstate.params)
    tl = _leaves(restored.params)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])


def test_engine_refuses_audio_as_the_reference_does():
    """Both engines raise ``NotImplementedError`` with the same message
    for an audio config."""
    cfg, tcfg, jp, tp = _setup()
    kw = dict(n_slots=2, page_size=4, n_pages=9)
    with pytest.raises(NotImplementedError) as ref:
        JEngine(jp, cfg, **kw)
    with pytest.raises(NotImplementedError) as port:
        TEngine(tp, tcfg, device="cpu", **kw)
    assert str(port.value) == str(ref.value) == \
        "engine serves text/vlm configs"


def test_launchers_run_at_reduced(capsys):
    """``launch.train`` on audio batches and ``launch.serve_batched``
    (prefill and the static loop over (B, K, 1) frames) at ``reduced()``
    on the CPU; ``--engine`` raises."""
    from repro_torch.launch import serve_batched, train

    train.main(["--device", "cpu", "--arch", "musicgen_large", "--steps",
                "2", "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2
    serve_batched.main(["--device", "cpu", "--arch", "musicgen-large",
                        "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill(2x5)" in out and "decoded 3 tokens" in out
    with pytest.raises(NotImplementedError, match="text/vlm"):
        serve_batched.main(["--device", "cpu", "--arch", "musicgen_large",
                            "--engine", "--batch", "2", "--prompt-len", "5",
                            "--new-tokens", "3"])


def test_plans_at_head_width_64_g1():
    """K2 / K3's plan at musicgen's training shape (B 2, H = KH = 32, S
    1 024; G 1): K2 one head a block over B H = 64 blocks of 8 q tiles,
    K3 clusters of one block, 64 blocks of 8 kv tiles, the shared memory
    of tinyllava's width-64 plan; K6 / K7's at its generate shape (4 rows,
    32 kv heads, G 1, rings of 1 056 = 66 virtual pages): clusters of 2
    (4 x 32 blocks leave SMs idle), 33 pages a rank, rounds within
    PAGED_ROUND_BYTES, two buffers."""
    dq, dkv = tops.flash_bwd_plan(2, 32, 32, 1024, 1024, 64)
    assert dq.heads == dkv.heads == ((0,),)
    assert (dq.grid, dkv.grid, dkv.cluster) == ((64, 8), (64, 8), 1)
    base = tops.flash_bwd_plan(4, 20, 5, 1024, 1024, 64)
    assert (dq.smem, dkv.smem) == (base[0].smem, base[1].smem)
    assert len(base[0].heads[0]) > 1  # tinyllava's G 4 sweeps more
    for elem in (2, 1):
        plan = tops.decode_paged_plan(4, 32, 1056 // tops.RING_PAGE,
                                      tops.RING_PAGE, 1, elem, 64)
        row = tops.decode_row(64, elem) * elem
        assert plan.cluster == 2 and plan.pages_per_rank == 33
        assert plan.pages_per_round == min(
            33, tops.PAGED_ROUND_BYTES // (2 * tops.RING_PAGE * row))
        assert plan.buffers == 2 and plan.grid == 4 * 32 * 2
        assert plan.smem <= tops.SMEM_MAX


def test_smoke_runs_the_rwkv6_and_musicgen_phases_and_g1_rows():
    """``chip_smoke.py`` has phases 29 - 32 (rwkv6 serve and train,
    musicgen serve and train) and runs them in ``main``; its kernels phase
    holds K1 - K3 and K6 / K7 at head width 64, G 1 (rows ``*_d64g1`` of
    the kernels line); ``scripts/smoke_phases.py`` names flash64g1 /
    ring64g1 and the four phases."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    smoke = (root / "chip_smoke.py").read_text()
    funcs = {n.name for n in ast.parse(smoke).body
             if isinstance(n, ast.FunctionDef)}
    phases = ("rwkv6_serve", "rwkv6_train", "musicgen_serve",
              "musicgen_train")
    assert {f"phase_{p}" for p in phases} <= funcs
    for p in phases:
        call = f'_timed("{p.replace("_", " ")}", phase_{p})'
        assert call in smoke, call
    for call in ("check_flash(gen, results, g1=True)",
                 "check_flash_bwd(gen, results, g1=True)",
                 "check_ring_decode(gen, results, g1=True)",
                 'D64G1 = "_d64g1"',
                 "[k + D64G1 for k in by_width[:5]]"):
        assert call in smoke, call
    for n in range(29, 33):
        assert f"\n{n}. " in smoke.split('"""')[1], n
    runner = (root / "scripts" / "smoke_phases.py").read_text()
    for name in ('"flash64g1": (64, None)', '"ring64g1"') + tuple(
            f"``{p}``" for p in phases):
        assert name in runner, name
