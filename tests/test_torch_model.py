"""The port's layers and model against the JAX reference, on the CPU, in
fp32, from the reference's own parameters (``from_jax_params``)."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import embedding as jemb  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro.models.layers import rope as jrope  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers import embedding as temb  # noqa: E402
from repro_torch.models.layers import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import norms as tnorms  # noqa: E402
from repro_torch.models.layers import rope as trope  # noqa: E402
from repro_torch.serve import paged as tpaged  # noqa: E402

ATOL = 1e-5
CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()


@pytest.fixture(scope="module")
def params():
    jp = jtf.init_params(jax.random.PRNGKey(0), CFG)
    return jp, from_jax_params(jp, "cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    _close(tnorms.rms_norm(_t(x), _t(w), 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = np.array([0, 3, 7, 100, 4095, 9], np.int32)
    tc, ts = trope.rope_angles(_t(pos), 16, 1e4)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 16, 1e4)
    _close(tc, jc)
    _close(ts, js)
    xh = rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
    _close(trope.apply_rope(_t(xh), tc, ts),
           jrope.apply_rope(jnp.asarray(xh), jc, js))
    mlp = {"w1": rng.normal(size=(32, 48)), "b1": rng.normal(size=(48,)),
           "w2": rng.normal(size=(48, 32)), "b2": rng.normal(size=(32,))}
    mlp = {k: (0.2 * v).astype(np.float32) for k, v in mlp.items()}
    _close(tmlp.mlp_forward({k: _t(v) for k, v in mlp.items()}, _t(x)),
           jmlp.mlp_forward({k: jnp.asarray(v) for k, v in mlp.items()},
                            jnp.asarray(x)))
    ffn = {k: (0.2 * rng.normal(size=s)).astype(np.float32)
           for k, s in (("w_gate", (32, 40)), ("w_up", (32, 40)),
                        ("w_down", (40, 32)))}
    _close(tmlp.swiglu_forward({k: _t(v) for k, v in ffn.items()}, _t(x)),
           jmlp.swiglu_forward({k: jnp.asarray(v) for k, v in ffn.items()},
                               jnp.asarray(x)))
    emb = {"emb": rng.normal(size=(50, 32)).astype(np.float32)}
    toks = np.array([[1, 49, 0], [7, 7, 3]], np.int32)
    _close(temb.embed({"emb": _t(emb["emb"])}, _t(toks), torch.float32),
           jemb.embed({"emb": jnp.asarray(emb["emb"])}, jnp.asarray(toks),
                      jnp.float32))
    _close(temb.head_logits({"w": _t(w[:, None] * np.ones((1, 9)))}, _t(x)),
           jemb.head_logits({"w": jnp.asarray(w[:, None] * np.ones((1, 9)))},
                            jnp.asarray(x)))


def test_init_params_shapes_match_reference(params):
    jp, _ = params
    tp = ttf.init_params(TCFG, seed=0, device="cpu")

    def shapes(tree, conv):
        if isinstance(tree, dict):
            return {k: shapes(v, conv) for k, v in tree.items()}
        return conv(tree)

    assert shapes(tp, lambda t: (tuple(t.shape), str(t.dtype))) == shapes(
        jp, lambda a: (tuple(a.shape), "torch." + str(a.dtype)))
    # same scales: embeddings 0.02, projections fan_in^-1/2
    assert abs(float(tp["embed"]["emb"].std()) - 0.02) < 2e-3
    wq = tp["server"]["seg0"]["attn"]["wq"]
    assert abs(float(wq.std()) * CFG.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("image_features", [False, True])
def test_forward_logits_and_caches_match_reference(params, image_features):
    jp, tp = params
    rng = np.random.default_rng(1)
    b, p, n_img = 2, 10, CFG.n_image_tokens
    toks = rng.integers(1, CFG.vocab_size, (b, p)).astype(np.int32)
    if image_features:
        img = rng.normal(size=(b, n_img, CFG.d_model)).astype(np.float32)
        jb, tb = dict(image_features=jnp.asarray(img)), dict(
            image_features=_t(img))
    else:
        img = rng.normal(size=(b, n_img, CFG.d_vision)).astype(np.float32)
        jb, tb = dict(image_embeds=jnp.asarray(img)), dict(
            image_embeds=_t(img))
    jb["tokens"], tb["tokens"] = jnp.asarray(toks), _t(toks)
    jl, jaux, jc = jtf.forward(jp, CFG, jb, collect_cache=32)
    tl, taux, tc = ttf.forward(tp, TCFG, tb, collect_cache=32)
    _close(tl, jl)
    _close(taux["commit"], jaux["commit"], atol=1e-6)
    for side in ("client", "server"):
        for leaf in ("k", "v"):
            _close(tc[side]["seg0"][leaf], jc[side]["seg0"][leaf])
        np.testing.assert_array_equal(tc[side]["seg0"]["pos"].numpy(),
                                      np.asarray(jc[side]["seg0"]["pos"]))


def test_decode_step_paged_matches_reference(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    n_pages, pg = 9, 4
    jpools = jtf.init_paged_caches(CFG, n_pages, pg, dtype=jnp.float32)
    tpools = ttf.init_paged_caches(TCFG, n_pages, pg, dtype=torch.float32,
                                   device="cpu")
    pt = np.array([[1, 2, 3, 4], [5, 6, -1, -1], [-1, -1, -1, -1]],
                  np.int32)
    for t in range(6):
        toks = rng.integers(1, CFG.vocab_size, (3, 1)).astype(np.int32)
        qpos = np.array([t, t, -1], np.int32)
        jl, jpools = jtf.decode_step_paged(jp, CFG, jpools,
                                           dict(tokens=jnp.asarray(toks)),
                                           jnp.asarray(qpos),
                                           jnp.asarray(pt))
        tl, tpools = ttf.decode_step_paged(tp, TCFG, tpools,
                                           dict(tokens=_t(toks)), _t(qpos),
                                           _t(pt))
        _close(tl[:2], np.asarray(jl)[:2], atol=1e-4)
    for side in ("client", "server"):
        np.testing.assert_array_equal(
            tpools[side]["seg0"]["pos"].numpy(),
            np.asarray(jpools[side]["seg0"]["pos"]))
        for leaf in ("k", "v"):  # page 0 is the trash page
            _close(tpools[side]["seg0"][leaf][:, 1:],
                   np.asarray(jpools[side]["seg0"][leaf])[:, 1:])


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_params(TCFG, seed=0)


@pytest.mark.parametrize("make", [
    lambda: tattn.init_kv_cache(1, 8, 2, 16),
    lambda: tattn.init_paged_kv_pool(4, 4, 2, 16),
    lambda: ttf.init_paged_caches(TCFG, 4, 4),
    lambda: tpaged.init_pools(TCFG, 4, 4),
], ids=["init_kv_cache", "init_paged_kv_pool", "init_paged_caches",
        "init_pools"])
def test_cache_constructors_raise_without_cuda(make):
    """With no device given, the caches go to CUDA, as every entry point
    of the port does, and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_unported_model_features_raise():
    import dataclasses

    with pytest.raises(NotImplementedError, match="K7/K9"):
        ttf.init_paged_caches(dataclasses.replace(TCFG, kv_cache_bits=8),
                              4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="M11"):
        ttf.init_params(dataclasses.replace(TCFG, modality="text"),
                        device="cpu")
