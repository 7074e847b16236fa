"""The feature-inversion attack (``repro_torch/attack``,
``repro_torch/launch/privacy_attack.py``) against the JAX reference
(``repro/attack/inversion.py``, ``benchmarks/fig4_attack.py``), on the
CPU in fp32: the resize, the forward, the loss and its gradients on the
reference's weights carried across (HWIO -> OIHW), 5 AdamW steps on the
reference's batch indices, each deployment's wire features against the
reference's, and Figure 4's ordering by the port's ``run`` on the
reference's own images and features at ``tinyllava.reduced()``."""
import pytest

pytest.importorskip("jax")

import functools  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import fig4_attack as jfig4  # noqa: E402
from repro.attack import inversion as jinv  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers.mlp import mlp_forward as jmlp  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_update as jadamw  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.attack import inversion as tinv  # noqa: E402
from repro_torch.bridge import from_jax_attack_params  # noqa: E402
from repro_torch.launch import privacy_attack as tfig4  # noqa: E402
from repro_torch.optim import init_opt_state as tinit_opt  # noqa: E402

GRID = (4, 4)
# fp32 sums (convolutions, means) in another order
RTOL = 1e-5
# the weights after AdamW steps, a step's worth: AdamW moves a weight by up
# to lr = 1e-3 a step whatever its gradient's size, so an element whose
# gradient is summation noise moves by noise (measured: 2.8e-6 on one of
# 147 456 elements of w0 after 5 steps); 1% of lr a step
WEIGHT_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.as_tensor(np.array(a)).permute(0, 3, 1, 2).contiguous()


def _oihw(g):
    """A reference gradient leaf in the port's layout."""
    g = np.asarray(g)
    return g.transpose(3, 2, 0, 1) if g.ndim == 4 else g


@functools.lru_cache(maxsize=None)
def _reference_data():
    """The reference script's images (NHWC) and clean connector features
    at ``tinyllava.reduced()``, as ``fig4_attack.run`` makes them, and its
    attack key."""
    cfg = get_config("tinyllava").reduced()
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    k_img, k_proj, k_attack = jax.random.split(jax.random.PRNGKey(42), 3)
    imgs, _ = jfig4._make_images(k_img, jfig4.N_TRAIN + jfig4.N_VAL)
    proj = jax.random.normal(k_proj, (jfig4.PATCH * jfig4.PATCH,
                                      cfg.d_vision)) \
        * (jfig4.PATCH * jfig4.PATCH) ** -0.5
    feats = jmlp(params["connector"], jfig4._patchify(imgs) @ proj)
    return np.array(imgs), np.array(feats), k_attack


def _batch(seed, b=4, d=48):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, 16, d)).astype(np.float32)
    imgs = np.tanh(rng.normal(size=(b, 32, 32, 1))).astype(np.float32)
    return feats, imgs


def test_upsample_matches_jax_resize():
    """``upsample2x`` (NCHW) against ``jax.image.resize(bilinear)`` (NHWC)
    on a ragged (2, 5, 7, 3) input: within 1e-6."""
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jinv.upsample2x(jnp.asarray(x)))
    got = tinv.upsample2x(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_bridged_params_and_init_shapes():
    """``from_jax_attack_params`` turns every HWIO kernel into OIHW, leaf
    for leaf, and the port's own init has those shapes."""
    jp = jinv.init_attack_params(jax.random.PRNGKey(1), 48)
    tp = from_jax_attack_params(jp, "cpu")
    own = tinv.init_attack_params(48, seed=0, device="cpu")
    assert tp.keys() == own.keys() == jp.keys()
    for k in jp:
        assert tp[k].shape == own[k].shape, k
        np.testing.assert_array_equal(tp[k].numpy(), _oihw(jp[k]))


def test_forward_loss_and_grads_match_reference():
    """Reconstructed images, the loss and the gradient of every leaf on
    the reference's weights: within 1e-5 of each one's scale."""
    jp = jinv.init_attack_params(jax.random.PRNGKey(1), 48)
    tp = from_jax_attack_params(jp, "cpu")
    feats, imgs = _batch(2)

    def jloss(p):
        pred = jinv.attack_forward(p, jnp.asarray(feats), GRID)
        return jinv.reconstruction_loss(pred, jnp.asarray(imgs)), pred

    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    pred = tinv.attack_forward(tp, torch.as_tensor(feats), GRID)
    loss = tinv.reconstruction_loss(pred, _nchw(imgs))
    loss.backward()
    assert pred.shape == (4, 1, 32, 32)
    np.testing.assert_allclose(pred.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jpred), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    for k in jp:
        ref = _oihw(jg[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), ref,
                                   atol=RTOL * float(np.abs(ref).max()),
                                   err_msg=k)


def _reference_indices(key, n_steps, n, batch=16):
    """``train_attack``'s batch indices: a key split each step."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (batch,), 0, n)))
    return np.stack(out)


def test_five_steps_match_reference_on_its_indices():
    """5 AdamW steps (lr 1e-3, weight decay 1e-5, clip 10) from the
    reference's init, on the reference's batch indices: the training loss
    of every step and the validation loss where ``train_attack`` records
    it (after step 1 and step 5) within 1e-5 relative, the final weights
    within 1% of the 5 lr that AdamW can move them."""
    imgs, feats, key = _reference_data()
    n, steps = jfig4.N_TRAIN, 5
    ftr, itr = feats[:n], imgs[:n]
    fva, iva = feats[n:n + 32], imgs[n:n + 32]
    _, jhist = jinv.train_attack(key, ftr, itr, fva, iva, grid=GRID,
                                 n_steps=steps)
    idx = _reference_indices(key, steps, n)
    jp = jinv.init_attack_params(key, feats.shape[-1])
    opt_cfg = JAdamW(lr=1e-3, weight_decay=1e-5, clip_norm=10.0)
    jopt = jinit_opt(jp, opt_cfg)

    @jax.jit
    def jstep(p, opt, f, im):
        loss, g = jax.value_and_grad(lambda q: jinv.reconstruction_loss(
            jinv.attack_forward(q, f, GRID), im))(p)
        p, opt, _ = jadamw(p, g, opt, opt_cfg)
        return p, opt, loss

    jlosses = []
    for i in range(steps):
        jp, jopt, jl = jstep(jp, jopt, ftr[idx[i]], itr[idx[i]])
        jlosses.append(float(jl))

    tftr, titr = torch.as_tensor(ftr), _nchw(itr)
    tfva, tiva = torch.as_tensor(fva), _nchw(iva)
    p = from_jax_attack_params(jinv.init_attack_params(
        key, feats.shape[-1]), "cpu")
    opt_cfg_t = tinv.attack_opt_config()
    opt = tinit_opt(p, opt_cfg_t)
    losses, thist = [], []
    for i in range(steps):
        sel = torch.as_tensor(idx[i])
        p, opt, loss = tinv.attack_step(p, opt, opt_cfg_t, tftr[sel],
                                        titr[sel], GRID)
        losses.append(loss.item())
        if i % 25 == 0 or i == steps - 1:
            thist.append(float(tinv.val_loss(p, tfva, tiva, GRID)))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    np.testing.assert_allclose(thist, jhist, rtol=RTOL)
    for k in jp:
        np.testing.assert_allclose(p[k].numpy(), _oihw(jp[k]),
                                   atol=WEIGHT_ATOL * steps, err_msg=k)


@pytest.mark.parametrize("name,method", [("qlora_nf_2bit", "nf"),
                                         ("rdfsq_2bit", "rdfsq")])
def test_wire_features_match_reference(name, method):
    """What crosses each deployment's wire, ``decode(encode(x))`` of the
    run's codec, against the reference: within one float32 ulp of the
    reference's own kernel layout (``impl="pallas"``, its NF ranges
    through fp16; XLA fuses an FMA); and against the reference script's
    ``roundtrip(x)[0]`` no further than the reference's own kernel layout
    is from it, plus that ulp.  For RD-FSQ that gap is the STE's
    ``x + (q - x)``, an ulp; for NF the fp16 range of the kernel layout
    against the flat stream's fp32 one."""
    _, feats, _ = _reference_data()
    qcfg = dict(tfig4.DEPLOYMENTS)[name]
    assert qcfg.method == method and qcfg.bits == 2
    jcfg = jq.QuantConfig(method=method, bits=2)
    got = tfig4.wire_features(qcfg, torch.as_tensor(feats)).numpy()
    layout = np.asarray(jq.decode(jcfg, jq.encode(
        jcfg, jnp.asarray(feats), impl="pallas")))
    rt = np.asarray(jq.roundtrip(jcfg, jnp.asarray(feats))[0])
    ulp = float(np.spacing(np.abs(rt).max()))
    np.testing.assert_allclose(got, layout, rtol=0, atol=ulp)
    assert np.all(np.abs(got - rt) <= np.abs(layout - rt) + ulp)
    # the 16-bit deployment ships the features themselves
    clean = torch.as_tensor(feats)
    assert tfig4.wire_features(None, clean) is clean


def test_run_orders_deployments_as_figure_4():
    """The port's ``run``, 250 steps a deployment at ``tinyllava.reduced()``
    on the reference's own images and features (its wire through the
    port's codecs, its attack's weights and batches from the run's
    seed): validation loss RD-FSQ > NF > original, as the reference's
    run gives (0.3926 > 0.3691 > 0.3589)."""
    imgs, feats, _ = _reference_data()
    out = tfig4.run(250, device="cpu", images=_nchw(imgs),
                    features=torch.as_tensor(feats), log=None)
    r = out["results"]
    assert all(np.isfinite(v) for v in r.values())
    assert out["ordered"], r
    assert len(out["histories"]["rdfsq_2bit"]) == 11
