"""zamba2_2_7b in the port (a Mamba2 backbone with Zamba2's
parameter-shared attention block) against the JAX reference, on the CPU,
in fp32, at ``reduced()`` (a mamba2 layer on the client, the shared block
on the server) and on a 6-layer config with ``hybrid_attn_every=3`` and
the cut at 3, so that a shared block falls on each side: the config and
its segments, the parameter tree and the bridge, the forward's logits and
collected caches (KV, SSM state, convolution), decode steps over 16-bit
and int8 KV caches, greedy ``generate`` token for token, a training
step's loss and gradients (the shared block's leaves summed over its uses,
the embedding through the shared blocks' ``emb0``), the paged engine's
refusal, the launchers, the K1 count of a training step, and K2 / K3's
and K6 / K7's launch plans at head width 80."""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

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
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

# fp32 on both sides, sums in another order: logits and caches within
# ATOL, a decode step's logits within DECODE_ATOL (arch zoo's tolerances);
# a training step's as tests/test_torch_train.py's (loss rtol 1e-5, each
# gradient leaf 1e-4 of its max |leaf| plus 1e-6)
ATOL, DECODE_ATOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(0)
CACHE = 40
CONFIGS = ["reduced", "six"]


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


def _cfgs(kind, **upd):
    """(reference, port) configs: ``reduced()``, or ``six``: 6 layers,
    a shared block every 3 (layers 2 and 5), the cut at 3."""
    ref, port = get_config("zamba2_2_7b").reduced(), \
        tget("zamba2_2_7b").reduced()
    if kind == "six":
        upd = dict(n_layers=6, hybrid_attn_every=3, **upd)
        out = []
        for c in (ref, port):
            out.append(dataclasses.replace(c, split=dataclasses.replace(
                c.split, cut_layer=3), **upd))
        return tuple(out)
    return (dataclasses.replace(ref, **upd), dataclasses.replace(port, **upd))


@functools.lru_cache(maxsize=None)
def _setup(kind, bits=16):
    """(reference cfg, port cfg, reference params, port params), the
    port's crossed by ``from_jax_params``."""
    cfg, tcfg = _cfgs(kind, kv_cache_bits=bits)
    jp = jtf.init_params(KEY, cfg)
    return cfg, tcfg, jp, from_jax_params(jp, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_prefill(cfg):
    return jax.jit(functools.partial(jtf.forward, cfg=cfg,
                                     collect_cache=CACHE))


def _prompts(cfg, b=2, plen=9, seed=11):
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


def _close_caches(tc, jc):
    """Every collected cache leaf: KV rings (k, v, pos; int8 codes and
    fp16 scales), SSM states and convolution caches."""
    tl = dict(tree_flatten_with_path(tc))
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    jl = {tuple(str(k.key) for k in p): x for p, x in flat}
    assert tl.keys() == jl.keys()
    for path, j in jl.items():
        t = tl[path]
        assert tuple(t.shape) == j.shape, path
        if path[-1] in ("pos", "k", "v") and t.dtype in (torch.int32,
                                                         torch.int8):
            # positions, and int8 codes (a code may move by one where the
            # absmax scaling rounds at a half)
            diff = np.abs(t.numpy().astype(np.int32)
                          - np.asarray(j).astype(np.int32))
            assert diff.max() <= (0 if path[-1] == "pos" else 1), path
        else:
            _close(t, j)


# ---------------------------------------------------------------------------
# config, pattern, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full"] + CONFIGS)
def test_config_and_segments_match_reference(kind):
    """``dataclasses.asdict``, the block pattern, the segments and the cut
    of the full, reduced and 6-layer configs equal the reference's; the
    alias names the same config."""
    if kind == "full":
        ref, port = get_config("zamba2_2_7b"), tget("zamba2_2_7b")
        assert tget("zamba2-2.7b") is port
    else:
        ref, port = _cfgs(kind)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.block_pattern() == ref.block_pattern()
    assert port.client_server_segments() == ref.client_server_segments()


def test_full_config_keeps_its_published_shapes():
    """54 layers: 45 mamba2 and 9 uses of the shared block (layers 5, 11,
    ..., 53), 4 on the client and 5 on the server of the cut at 27; 32 /
    32 heads of width 80 (G 1); the SSM's 80 heads of 64, d_state 64."""
    cfg = tget("zamba2_2_7b")
    pat = cfg.block_pattern()
    assert (len(pat), pat.count("mamba2"), pat.count("shared_attn")) == \
        (54, 45, 9)
    assert [i for i, t in enumerate(pat) if t == "shared_attn"] == \
        list(range(5, 54, 6))
    client, server = cfg.client_server_segments()
    assert cfg.split.resolve_cut(cfg.n_layers) == 27
    assert sum(t == "shared_attn" for t, _ in client) == 4
    assert sum(t == "shared_attn" for t, _ in server) == 5
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 32, 80)
    assert (cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
            cfg.ssm_state) == (80, 64)


@pytest.mark.parametrize("kind", CONFIGS)
def test_init_params_and_bridge_match_reference_tree(kind):
    """The port's ``init_params`` gives the reference's tree key for key
    and shape for shape (the top-level ``shared_attn``, its segments' empty
    dicts, the stacked mamba2 layers), and ``from_jax_params`` carries the
    reference's tree across leaf for leaf."""
    _, tcfg, jp, tp = _setup(kind)
    port = ttf.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(port) == _shapes(jp) == _shapes(tp)
    assert all(port[side][seg] == {} for side in ("client", "server")
               for seg, (t, _) in zip(
                   port[side], tcfg.client_server_segments()[
                       side == "server"]) if t == "shared_attn")
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])


def test_bf16_trees_keep_the_ssm_leaves_fp32():
    """In bf16: the port's and the reference's trees have the same dtype
    leaf for leaf (A_log, D and dt_bias fp32, the rest bf16), and so does
    the bridge's copy without ``dtype=``."""
    cfg, tcfg = _cfgs("six", param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    jp = jtf.init_params(KEY, cfg)
    port = ttf.init_params(tcfg, seed=0, device="cpu")
    bridged = from_jax_params(jp, "cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = {tuple(str(k.key) for k in p): str(x.dtype) for p, x in flat}
    for tree in (port, bridged):
        got = {p: str(x.dtype).removeprefix("torch.")
               for p, x in tree_flatten_with_path(tree)}
        assert got == want
    assert {p[-1] for p, d in want.items() if d == "float32"} == \
        {"A_log", "D", "dt_bias"}


# ---------------------------------------------------------------------------
# forward, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", CONFIGS)
def test_forward_logits_and_caches_match_reference(kind):
    """Logits, the commitment loss and every collected cache (the shared
    blocks' KV rings with their leading axis of 1, the mamba2 layers'
    state and conv) of a prefill of 2 x 9 tokens into a ring of 40."""
    cfg, tcfg, jp, tp = _setup(kind)
    jb, tb = _prompts(cfg)
    jl, jaux, jc = _jax_prefill(cfg)(jp, batch=jb)
    tl, taux, tc = ttf.forward(tp, tcfg, tb, collect_cache=CACHE)
    _close(tl, jl)
    _close(taux["commit"], jaux["commit"])
    _close_caches(tc, jc)
    shared = [(side, f"seg{i}") for side, segs in zip(
        ("client", "server"), tcfg.client_server_segments())
        for i, (t, _) in enumerate(segs) if t == "shared_attn"]
    for side, seg in shared:
        assert tc[side][seg]["k"].shape[0] == 1


@pytest.mark.parametrize("bits", [16, 8])
def test_decode_steps_match_reference(bits):
    """Four one-token steps after the prefill (6-layer config) over 16-bit
    or int8 KV rings: logits within DECODE_ATOL, then every cache."""
    cfg, tcfg, jp, tp = _setup("six", bits)
    jb, tb = _prompts(cfg)
    _, _, jc = _jax_prefill(cfg)(jp, batch=jb)
    _, _, tc = ttf.forward(tp, tcfg, tb, collect_cache=CACHE)
    step = jax.jit(functools.partial(jtf.decode_step, cfg=cfg))
    rng = np.random.default_rng(4)
    for i in range(4):
        toks = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        qpos = np.full((2,), 9 + i, np.int32)
        jl, jc = step(jp, caches=jc, batch=dict(tokens=jnp.asarray(toks)),
                      qpos=jnp.asarray(qpos))
        tl, tc = ttf.decode_step(tp, tcfg, tc, dict(tokens=_t(toks)),
                                 _t(qpos))
        _close(tl, jl, DECODE_ATOL)
    _close_caches(tc, jc)


@pytest.mark.parametrize("kind", CONFIGS)
def test_generate_token_exact_vs_reference(kind):
    """Greedy ``generate``, prefill included, 8 new tokens, token for token
    against the reference's (a ring of 40 slots)."""
    cfg, tcfg, jp, tp = _setup(kind)
    jb, tb = _prompts(cfg, b=3, seed=12)
    ref = np.asarray(jsd.generate(jp, cfg, jb, n_new=8, cache_len=CACHE))
    out = tsd.generate(tp, tcfg, tb, n_new=8, cache_len=CACHE).numpy()
    assert out.shape == (3, 8)
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", CONFIGS)
def test_train_step_loss_and_grads_match_reference(kind):
    """One training step's composite loss and every gradient leaf against
    ``jax.grad`` on a batch of the data pipeline (2 x 24 positions): the
    mamba2 leaves, the shared block's (summed over its uses on both sides
    of the cut) and the embedding's (through the shared blocks' emb0)."""
    cfg, tcfg, jp, tp = _setup(kind)
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
    assert any(k.startswith("shared_attn/") for k in jl)
    for k in jl:
        tol = 1e-4 * float(np.abs(jl[k]).max()) + 1e-6
        np.testing.assert_allclose(tl[k], jl[k], atol=tol, err_msg=k)
    assert float(np.abs(tl["shared_attn/w_in"]).max()) > 0


def test_layer_forward_count_is_the_shared_uses():
    """K1 runs once a use of the shared block in a training step (no remat
    around it) and never in a mamba2 layer: 9 at full depth, whatever the
    remat policy of the mamba2 segments."""
    x = torch.empty((2, 1024, 2560), device="meta")
    cfg = tget("zamba2_2_7b")
    for remat in (True, False):
        assert ttf.layer_forward_count(
            dataclasses.replace(cfg, remat=remat), x) == 9
    assert ttf.layer_forward_count(_cfgs("six")[1], x[..., :256]) == 2


# ---------------------------------------------------------------------------
# refusals, launchers, plans
# ---------------------------------------------------------------------------

def test_engine_and_paged_pools_refuse_mamba2_as_the_reference_does():
    """Paged pools have no mamba2 form: both engines raise
    ``NotImplementedError`` with the same message, and so does the port's
    ``init_paged_caches``."""
    cfg, tcfg, jp, tp = _setup("reduced")
    kw = dict(n_slots=2, page_size=4, n_pages=9)
    with pytest.raises(NotImplementedError) as ref:
        JEngine(jp, cfg, **kw)
    with pytest.raises(NotImplementedError) as port:
        TEngine(tp, tcfg, device="cpu", **kw)
    assert str(port.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="mamba2"):
        ttf.init_paged_caches(tcfg, 9, 4, device="cpu")


def test_launchers_run_at_reduced(capsys):
    """``launch.train`` and ``launch.serve_batched`` (prefill and the
    static loop) at ``reduced()`` on the CPU; ``--engine`` raises."""
    from repro_torch.launch import serve_batched, train

    train.main(["--device", "cpu", "--arch", "zamba2_2_7b", "--steps", "2",
                "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2
    serve_batched.main(["--device", "cpu", "--arch", "zamba2-2.7b",
                        "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill(2x5)" in out and "decoded 3 tokens" in out
    with pytest.raises(NotImplementedError, match="mamba2"):
        serve_batched.main(["--device", "cpu", "--arch", "zamba2_2_7b",
                            "--engine", "--batch", "2", "--prompt-len", "5",
                            "--new-tokens", "3"])


def test_plans_at_head_width_80():
    """K2 / K3's plan at zamba2's training shape (B 2, H = KH = 32, S
    1 024; G 1): the tiles of the padded width 96, two Q / dO slots and 3
    ring stages for K2, clusters of one block for K3, the grid of any
    width; K6 / K7's at its generate shape (4 rows, 32 kv heads, G 1, a
    ring of 544): clusters of 2, bf16 rows of 88 in rounds of at most
    32 KB."""
    dq, dkv = tops.flash_bwd_plan(2, 32, 32, 1024, 1024, 80, 80)
    assert tops.padded(80) == 96
    assert dq.smem == 1024 + 2 * 128 * 192 * 2 + 3 * 64 * 192 * 2 \
        + (4 + 6) * 8 + 32 + 16 * 4
    assert dkv.smem == 1024 + (128 + 3 * 64) * 192 * 2 + 3 * 3 * 64 * 4 \
        + 7 * 8 + 32 + 16 * 4
    base = tops.flash_bwd_plan(2, 32, 32, 1024, 1024, 64)
    assert (dq.grid, dkv.grid, dkv.cluster) == \
        (base[0].grid, base[1].grid, 1)
    # K3's partials (dK, dV rows of 80 + 8 floats, 128 keys) fit over the
    # ring they overlay
    assert 2 * 128 * (80 + 8) * 4 <= (128 + 3 * 64) * 192 * 2
    for elem in (2, 1):
        plan = tops.decode_paged_plan(4, 32, 34, tops.RING_PAGE, 1, elem,
                                      80)
        row = (88 if elem == 2 else 80) * elem
        assert plan.cluster == 2 and plan.pages_per_rank == 17
        assert plan.pages_per_round == min(17, 32768 // (2 * 16 * row))
        assert plan.smem <= tops.SMEM_MAX


def test_smoke_runs_the_zamba2_phases_and_width_80():
    """``chip_smoke.py`` has the zamba2 serve and train phases and runs
    them in ``main``; its kernels phase holds K1 - K3 and K6 - K9 at 80;
    ``scripts/smoke_phases.py`` names flash80 / ring80 / paged80."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    smoke = (root / "chip_smoke.py").read_text()
    funcs = {n.name for n in ast.parse(smoke).body
             if isinstance(n, ast.FunctionDef)}
    assert {"phase_zamba2_serve", "phase_zamba2_train"} <= funcs
    for call in ('_timed("zamba2 serve", phase_zamba2_serve)',
                 '_timed("zamba2 train", phase_zamba2_train)',
                 "check_flash(gen, results, d=80, dv=80)",
                 "check_flash_bwd(gen, results, d=80, dv=80)",
                 "check_ring_decode(gen, results, d=80)",
                 "check_decode(gen, results, d=80)"):
        assert call in smoke, call
    runner = (root / "scripts" / "smoke_phases.py").read_text()
    for name in ('"flash80": (80, 80)', '"ring80"', '"paged80"'):
        assert name in runner, name
