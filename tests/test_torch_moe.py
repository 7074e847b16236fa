"""The port's Mixture-of-Experts layer (``repro_torch/models/layers/moe.py``)
against the JAX reference (``repro/models/layers/moe.py``), on the CPU:
the reference's own four MoE tests (``tests/test_layers.py``) mirrored on
the port, then outputs, auxiliaries, the chosen experts, the kept copies
and gradients on the reference's weights, at capacity 1.25 (drops) and
8.0, in fp32 and bf16, the reference's calls jitted."""
import pytest

pytest.importorskip("jax")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402

KEY = jax.random.PRNGKey(0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same products summed in another order.  bf16: two bf16 steps
# of the leaf's scale: each side rounds every product to bf16 and sums in
# its own order, and a gradient takes two such rounded products in a row
# (measured: 2 steps on one of 5 120 elements of the dense residual's
# w_down gradient; 0.87% of the scale on the router's, whose gate
# cotangents cancel through the softmax's backward)
ATOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
# the auxiliaries are fp32 whatever the dtype (the router runs in fp32)
AUX_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(d, e, f, dtype="float32", **kw):
    """(reference params, port params from them)."""
    jp = jmoe.init_moe_params(KEY, d, e, f, dtype=DTYPES[dtype][0], **kw)
    return jp, from_jax_params(jp, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_forward(top_k, capacity_factor):
    return jax.jit(functools.partial(jmoe.moe_forward, top_k=top_k,
                                     capacity_factor=capacity_factor))


def _jax_routing(params, x, top_k, capacity_factor):
    """The reference's routing and capacity decision, its own lines
    (``moe.py:106-142``) run to the expert ids and the keep mask."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    g = jmoe._pick_groups(t, 16)
    tg = t // g
    xg = x.reshape(g, tg, d)
    logits = xg.astype(jnp.float32) @ params["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, top_k)
    tk = tg * top_k
    cap = max(1, int(tk * capacity_factor / e))
    e_flat = expert_ids.reshape(g, tk)
    order = jnp.argsort(e_flat, axis=-1)
    sorted_e = jnp.take_along_axis(e_flat, order, axis=-1)
    starts = jax.vmap(
        lambda se: jnp.searchsorted(se, jnp.arange(e), side="left")
    )(sorted_e)
    pos_in_e = jnp.arange(tk)[None] - jnp.take_along_axis(
        starts, sorted_e, axis=-1)
    return np.asarray(expert_ids), np.asarray(pos_in_e < cap)


# ---------------------------------------------------------------------------
# the reference's MoE tests, on the port
# ---------------------------------------------------------------------------

def test_moe_routes_and_balances():
    """``tests/test_layers.py::test_moe_routes_and_balances``: shape,
    finiteness, load balance >= 1, at most half the copies dropped; and
    the same numbers as the reference's."""
    jp, tp = _pair(16, 4, 32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 16)))
    y, aux = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=2,
                              capacity_factor=2.0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux["load_balance"]) >= 1.0 - 1e-3
    assert float(aux["drop_fraction"]) <= 0.5
    jy, jaux = _jax_forward(2, 2.0)(jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   atol=1e-6, err_msg=k)


def test_moe_no_drops_at_high_capacity():
    """``test_moe_no_drops_at_high_capacity``: no drops at capacity 8."""
    _, tp = _pair(16, 4, 32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16)))
    _, aux = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=2,
                              capacity_factor=8.0)
    assert float(aux["drop_fraction"]) == 0.0


def test_moe_matches_dense_mixture_at_full_capacity():
    """``test_moe_matches_dense_mixture_at_full_capacity``: with no drops
    the sort-based dispatch equals the brute-force weighted experts."""
    d, k = 8, 2
    _, tp = _pair(d, 4, 16)
    x = torch.as_tensor(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (1, 6, d))))
    y, _ = tmoe.moe_forward(tp, x, top_k=k, capacity_factor=8.0)
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ tp["router"], -1)
    gv, ei = torch.topk(probs, k)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(k):
            e = int(ei[t, j])
            gate = torch.nn.functional.silu(xf[t] @ tp["w_gate"][e])
            ref[t] += gv[t, j] * ((gate * (xf[t] @ tp["w_up"][e]))
                                  @ tp["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, d).numpy(), ref.numpy(),
                               atol=1e-4, rtol=1e-3)


def test_moe_shared_and_dense_residual():
    """``test_moe_shared_and_dense_residual``: a shared expert and a dense
    residual; the reference's output on the same weights."""
    jp, tp = _pair(8, 4, 16, n_shared_experts=1, dense_residual_d_ff=32)
    assert set(tp) == {"router", "w_gate", "w_up", "w_down", "shared",
                       "dense_residual"}
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 4, 8)))
    y, _ = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=2)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    jy, _ = _jax_forward(2, 1.25)(jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)


# ---------------------------------------------------------------------------
# against the reference on the same weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_and_kept_copies_match_reference(dtype, capacity_factor):
    """The chosen experts and the keep mask equal the reference's, copy
    for copy, over 2 x 48 tokens in 16 groups of 6 (64 wide, 8 experts,
    top-2); so does the drop fraction, which at capacity 1.25 drops
    copies."""
    jp, tp = _pair(64, 8, 96, dtype, dense_residual_d_ff=80)
    x = _x(1, (2, 48, 64))
    jdt, tdt = DTYPES[dtype]
    jx, tx = jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)
    j_ids, j_keep = _jax_routing(jp, jx, 2, capacity_factor)
    g, tg = 16, 6
    _, _, gate_vals, ids = tmoe.route(tp["router"], tx.reshape(g, tg, 64), 2)
    cap = tmoe.capacity(tg, 2, 8, capacity_factor)
    _, keep, _, _ = tmoe.dispatch(ids, gate_vals, 8, cap)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    _, aux = tmoe.moe_forward(tp, tx, top_k=2,
                              capacity_factor=capacity_factor)
    _, jaux = _jax_forward(2, capacity_factor)(jp, jx)
    assert (float(aux["drop_fraction"]) > 0) == (capacity_factor == 1.25)
    np.testing.assert_allclose(float(aux["drop_fraction"]),
                               1.0 - j_keep.mean(), atol=1e-7)
    # the reference's XLA mean is 3e-8 off at no drops (1 - 0.99999997)
    np.testing.assert_allclose(float(aux["drop_fraction"]),
                               float(jaux["drop_fraction"]), atol=1e-7)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_outputs_aux_and_grads_match_reference(dtype, capacity_factor):
    """Outputs and the auxiliaries of ``moe_forward``, and the gradients of
    ``sum(y * c) + load_balance + router_z`` with respect to every
    parameter and the input, against the reference's on its weights (a
    dense residual beside the experts).  fp32 within 1e-5 of each leaf's
    scale; bf16 within two bf16 steps (2^-6) of it."""
    jp, tp = _pair(64, 8, 96, dtype, dense_residual_d_ff=80)
    x, c = _x(2, (2, 48, 64)), _x(3, (2, 48, 64))
    jdt, tdt = DTYPES[dtype]

    def jloss(p, x):
        y, aux = jmoe.moe_forward(p, x, top_k=2,
                                  capacity_factor=capacity_factor)
        return (jnp.sum(y.astype(jnp.float32) * c) + aux["load_balance"]
                + aux["router_z"]), (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x).astype(jdt))

    tp = {k: v.requires_grad_(True) if isinstance(v, torch.Tensor) else
          {kk: vv.requires_grad_(True) for kk, vv in v.items()}
          for k, v in tp.items()}
    tx = torch.as_tensor(x).to(tdt).requires_grad_(True)
    y, aux = tmoe.moe_forward(tp, tx, top_k=2,
                              capacity_factor=capacity_factor)
    (y.float() * torch.as_tensor(c)).sum().add(
        aux["load_balance"] + aux["router_z"]).backward()

    def close(t, j, what):
        j = np.asarray(j, np.float32)
        scale = float(np.abs(j).max()) or 1.0
        np.testing.assert_allclose(t.detach().float().numpy(), j,
                                   atol=ATOL[dtype] * scale, err_msg=what)

    close(y, jy, "y")
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=AUX_ATOL, err_msg=k)
    close(tx.grad, jgx, "dx")
    for k, v in tp.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                close(vv.grad, jgp[k][kk], f"d{k}/{kk}")
        else:
            close(v.grad, jgp[k], f"d{k}")


def test_decode_shaped_groups_and_one_slot_capacity():
    """A decode step's shape (4 tokens of one position: 4 groups of one
    token, capacity max(1, int(2 x 8 / 16)) = 1 at 16 experts) keeps every
    copy, and the output equals the reference's."""
    jp, tp = _pair(32, 16, 48, dense_residual_d_ff=40)
    x = _x(4, (4, 1, 32))
    assert tmoe._pick_groups(4) == 4 and tmoe.capacity(1, 2, 16, 8.0) == 1
    y, aux = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=2,
                              capacity_factor=8.0)
    jy, _ = _jax_forward(2, 8.0)(jp, jnp.asarray(x))
    assert float(aux["drop_fraction"]) == 0.0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("t", [1, 7, 16, 48, 96, 1000])
def test_pick_groups_matches_reference(t):
    assert tmoe._pick_groups(t) == jmoe._pick_groups(t, 16)


def test_scatter_is_deterministic_at_top_2():
    """Two runs give the same bits: at top-2 each token sums two copies
    onto zero, which no order of the adds can change."""
    _, tp = _pair(64, 8, 96, dense_residual_d_ff=80)
    x = torch.as_tensor(_x(5, (2, 48, 64)))
    a, _ = tmoe.moe_forward(tp, x, top_k=2)
    b, _ = tmoe.moe_forward(tp, x, top_k=2)
    assert torch.equal(a, b)
