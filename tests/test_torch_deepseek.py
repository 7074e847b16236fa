"""``deepseek_v2_236b`` in the port against the JAX reference, on the CPU:
the plain K1 - K3 at its MLA width pair (D, Dv) = (192, 128) against the
Pallas kernels in interpret mode and the jnp reference; K2 / K3's launch
plan at that pair (K2's one Q / dO slot, K3's kv tiles of 64 keys); the
MoE layer at top-6 over 16 experts with 2 shared experts (outputs,
auxiliaries, routing, the keep mask and gradients, the same bits twice,
and at top-2 the bits of the ``index_add`` combine it replaced); the whole
model cut to 3 layers with 16 experts, whose client holds a dense segment
and a moe segment (forward, latent caches, ``generate``, one training
step); the launchers at ``reduced()``."""
import pytest

pytest.importorskip("jax")

import ast  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.kernels import attention_ref as jref  # noqa: E402
from repro.kernels import flash_kernel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro.serve import decode as jsd  # noqa: E402
from repro.train.losses import composite_loss as jloss  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.serve import decode as tsd  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
FAR = 2 ** 30
# the plain flash kernels against the Pallas ones, relative to max |ref|;
# the model's logits and caches (tests/test_torch_arch_zoo.py's)
ATOL = 1e-5
D, DV = 192, 128


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


# ---------------------------------------------------------------------------
# the plain K1 - K3 at (192, 128)
# ---------------------------------------------------------------------------

# (sq, skv, h, kh, window, kv_valid_len, chunk)
D192_CASES = [
    (48, 48, 2, 2, None, None, 16),   # MLA's G = 1
    (40, 40, 2, 2, None, None, 16),   # padded q / kv tail
    (32, 48, 2, 2, None, 24, 16),     # kv_valid_len + longer kv
    (48, 48, 2, 2, 12, None, 16),     # window
    (48, 48, 4, 2, None, None, 16),   # G = 2
]


def _bhsd(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3))


def _operands(sq, skv, h, kh, window, kv_valid_len, chunk, seed=0):
    """Pre-scaled (by D^-1/2), chunk-padded (B, S, H, D / Dv) operands with
    sentinel positions, as the reference's flash_attention builds them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, sq, h, D)).astype(np.float32)
    k = rng.normal(size=(1, skv, kh, D)).astype(np.float32)
    v = rng.normal(size=(1, skv, kh, DV)).astype(np.float32)
    pad_q, pad_kv = (-sq) % chunk, (-skv) % chunk
    qs = np.pad(q * D ** -0.5, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
    k = np.pad(k, ((0, 0), (0, pad_kv), (0, 0), (0, 0)))
    v = np.pad(v, ((0, 0), (0, pad_kv), (0, 0), (0, 0)))
    qpos = np.pad(np.arange(sq, dtype=np.int32), (0, pad_q),
                  constant_values=-FAR)
    kpos = np.full(skv + pad_kv, FAR, np.int32)
    n = min(sq, skv)
    kpos[:n] = np.arange(n)
    if kv_valid_len is not None:
        kpos[kv_valid_len:] = FAR
    return qs, k, v, qpos, kpos


@pytest.mark.parametrize("case", D192_CASES)
def test_flash_forward_plain_d192_v128_matches_reference_kernel(case):
    """(out, m, l) of the plain K1 at (192, 128) against the Pallas kernel
    in interpret mode, on every row that sees a key (rows that see none
    are 0 in the port), and the wrapper against the jnp reference.
    Tolerance 1e-5 relative to max |ref|."""
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case)
    jo, jm, jl = flash_kernel.forward(
        jnp.asarray(_bhsd(qs)), jnp.asarray(_bhsd(k)), jnp.asarray(_bhsd(v)),
        jnp.asarray(qpos.reshape(-1, 1)), jnp.asarray(kpos.reshape(1, -1)),
        window=window, block=chunk, interpret=True)
    to, tm, tl = tops.flash_forward(_t(_bhsd(qs)), _t(_bhsd(k)),
                                    _t(_bhsd(v)), _t(qpos), _t(kpos),
                                    window=window)
    assert to.shape == (1, h, qs.shape[1], DV)
    seen = np.asarray(tl)[..., 0] > 0
    assert seen[:, :, :sq].all() and not seen[:, :, sq:].any()
    _close(torch.as_tensor(to.numpy()[seen]), np.asarray(jo)[seen])
    _close(torch.as_tensor(tm.numpy()[seen]), np.asarray(jm)[seen])
    np.testing.assert_allclose(tl.numpy()[seen], np.asarray(jl)[seen],
                               rtol=ATOL)
    assert np.all(to.numpy()[~seen] == 0)
    jr = jref.flash_reference(jnp.asarray(qs), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(qpos),
                              jnp.asarray(kpos), window, chunk)
    port = tops.flash(_t(qs), _t(k), _t(v), _t(qpos), _t(kpos), window)
    _close(port[:, :sq], np.asarray(jr)[:, :sq])


@pytest.mark.parametrize("case", D192_CASES)
def test_flash_backward_plain_d192_v128_matches_reference_kernels(case):
    """dq (width 192) / dk (192) / dv (128) of the plain K2 / K3 against
    the Pallas backward_dq / backward_dkv in interpret mode and the jnp
    VJP of flash_reference, fed the JAX forward's own (m, l) and di;
    padded q rows get a zero output gradient, as flash_attention gives
    them."""
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case)
    go = np.random.default_rng(5).normal(
        size=qs.shape[:3] + (DV,)).astype(np.float32)
    go[:, sq:] = 0.0
    jq, jk, jv = (jnp.asarray(_bhsd(a)) for a in (qs, k, v))
    jqp = jnp.asarray(qpos.reshape(-1, 1))
    jkp = jnp.asarray(kpos.reshape(1, -1))
    jo, jm, jl = flash_kernel.forward(jq, jk, jv, jqp, jkp, window=window,
                                      block=chunk, interpret=True)
    gob = _bhsd(go)
    di = np.sum(gob * np.asarray(jo), axis=-1, keepdims=True)
    kw = dict(window=window, block=chunk, interpret=True)
    jdq = flash_kernel.backward_dq(jq, jk, jv, jnp.asarray(gob), jm, jl,
                                   jnp.asarray(di), jqp, jkp, **kw)
    jdk, jdv = flash_kernel.backward_dkv(jq, jk, jv, jnp.asarray(gob), jm,
                                         jl, jnp.asarray(di), jqp, jkp, **kw)
    targs = [_t(_bhsd(a)) for a in (qs, k, v)] + [
        _t(gob), _t(jm), _t(jl), _t(di), _t(qpos), _t(kpos)]
    dq = tops.flash_backward_dq(*targs, window=window)
    dk, dv = tops.flash_backward_dkv(*targs, window=window)
    assert dq.shape[-1] == dk.shape[-1] == D and dv.shape[-1] == DV
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(port, ref)
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_reference(
        a, b_, c, jnp.asarray(qpos), jnp.asarray(kpos), window, chunk),
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))
    for port, ref in zip((dq, dk, dv), vjp(jnp.asarray(go))):
        _close(torch.as_tensor(_bhsd(port.numpy())), ref)


def test_flash_checks_take_d192_v128():
    """The flash checks admit (192, 128) with a (B, H, Sq, 128) output
    gradient; no pair is queued any more ((80, 80) is compiled too)."""
    assert {(192, 128), (80, 80)} <= set(tops.FLASH_HEAD_DIMS)
    assert not hasattr(tops, "_FLASH_QUEUED")
    q = torch.zeros(1, 4, 16, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 16, D, dtype=torch.bfloat16)
    v = torch.zeros(1, 4, 16, DV, dtype=torch.bfloat16)
    go = torch.zeros(1, 4, 16, DV, dtype=torch.bfloat16)
    pos = torch.arange(16, dtype=torch.int32)
    qpos, _ = tops._check_flash("K2", q, k, v, pos, pos, go)
    assert qpos.dtype == torch.int32
    with pytest.raises(ValueError, match="head_dim"):
        tops._check_flash("K1", q, k, torch.zeros(1, 4, 16, 192,
                                                  dtype=torch.bfloat16),
                          pos, pos)


# ---------------------------------------------------------------------------
# K2 / K3's plan at (192, 128)
# ---------------------------------------------------------------------------

# deepseek_v2_236b's training shape (G 1), a ragged G 1 case and a G 2
# case (K3's clusters of 2)
D192_PLAN_SHAPES = [(2, 128, 128, 1024, 1024), (1, 128, 128, 777, 777),
                    (1, 4, 2, 100, 100)]


@pytest.mark.parametrize("shape", D192_PLAN_SHAPES)
def test_flash_bwd_plan_at_d192_v128(shape):
    """K2 keeps one Q / dO slot of 128 rows and 3 ring stages of 64 keys;
    K3 kv tiles of 64 keys (its two warpgroups split dK / dV's columns),
    3 stages of Q / dO tiles of 64 rows and their row statistics; both
    fit the H100's 227 KB at the shape and at 32k positions, where two
    K2 slots would not; K2's grid and heads those of any width."""
    b, h, kh, sq, skv = shape
    dq, dkv = tops.flash_bwd_plan(b, h, kh, sq, skv, D, DV)
    nkv64, nq64 = -(-skv // 64), -(-sq // 64)
    assert dq.smem == 1024 + 1 * 128 * (D + DV) * 2 \
        + 3 * 64 * (D + DV) * 2 + (4 + 6) * 8 + 32 + nkv64 * 4
    assert dkv.smem == 1024 + (64 + 3 * 64) * (D + DV) * 2 \
        + 3 * 3 * 64 * 4 + 7 * 8 + 32 + nq64 * 4
    assert dkv.grid[1] == nkv64 and dkv.tiles == tuple(range(nkv64))
    base = tops.flash_bwd_plan(b, h, kh, sq, skv, 64)
    assert (dq.grid, dq.heads, dkv.grid[0], dkv.cluster, dkv.heads) == (
        base[0].grid, base[0].heads, base[1].grid[0], base[1].cluster,
        base[1].heads)
    if h == kh:  # G 1: one head a block, K3's clusters of one block
        assert dq.heads == dkv.heads == ((0,),) and dkv.cluster == 1
    for plan in tops.flash_bwd_plan(b, h, kh, 32768, 32768, D, DV) \
            + (dq, dkv):
        assert 48 * 1024 < plan.smem <= tops.SMEM_MAX == 232448
    # two Q / dO slots beside 2 stages would not fit
    assert 1024 + 2 * 128 * (D + DV) * 2 + 2 * 64 * (D + DV) * 2 \
        > tops.SMEM_MAX
    # K3's partials (64 keys of dK rows of 192 + 8 and dV rows of 128 + 8
    # floats) fit over the ring of tiles they overlay
    assert 64 * (D + 8) * 4 + 64 * (DV + 8) * 4 <= \
        (64 + 3 * 64) * (D + DV) * 2


@pytest.mark.parametrize("shape", D192_PLAN_SHAPES)
def test_flash_bwd_plan_at_d192_v128_covers_every_tile_once(shape):
    """K3's blocks take every (kv tile of 64 keys, query head, batch row)
    once, the blocks of a cluster one (kv tile, kv head, batch row), each
    sweeping its heads in order; K2's every (q tile of 128 rows, head,
    batch row) once."""
    b, h, kh, sq, skv = shape
    dq, dkv = tops.flash_bwd_plan(b, h, kh, sq, skv, D, DV)
    g, p = h // kh, len(dq.heads[0])
    dq_items = [(dq.tiles[y], x % (h // p) * p + j, x // (h // p))
                for y in range(dq.grid[1]) for x in range(dq.grid[0])
                for j in dq.heads[0]]
    clusters = []
    for y in range(dkv.grid[1]):
        for x0 in range(0, dkv.grid[0], dkv.cluster):
            clusters.append([
                [(dkv.tiles[y], ((x0 + r) // dkv.cluster % kh) * g + i,
                  (x0 + r) // dkv.cluster // kh) for i in dkv.heads[r]]
                for r in range(dkv.cluster)])

    def every(n_tiles):
        return Counter((t, hh, bb) for t in range(n_tiles)
                       for hh in range(h) for bb in range(b))

    assert Counter(dq_items) == every(-(-sq // 128))
    assert Counter(i for c in clusters for blk in c for i in blk) \
        == every(-(-skv // 64))
    for c in clusters:
        assert len({(t, hh // g, bb) for blk in c for t, hh, bb in blk}) == 1
        assert all([hh for _, hh, _ in blk] == sorted(hh for _, hh, _ in blk)
                   for blk in c)


# ---------------------------------------------------------------------------
# the MoE layer at top-6 with shared experts
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_torch_moe.py's tolerances: fp32 within 1e-5 of each leaf's
# scale, bf16 two bf16 steps (2^-6) of it; the auxiliaries (fp32) 1e-5
MOE_ATOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
AUX_ATOL = 1e-5
E, TOP_K, SHARED = 16, 6, 2


@functools.lru_cache(maxsize=None)
def _moe_pair(dtype, e=E, top2=False):
    """(reference params, port params from them) of a 64-wide MoE layer:
    ``e`` experts of width 48 beside 2 shared experts, or with ``top2``
    arctic's kind, experts of width 96 beside a dense residual of 80."""
    kw = (dict(dense_residual_d_ff=80) if top2
          else dict(n_shared_experts=SHARED))
    jp = jmoe.init_moe_params(KEY, 64, e, 96 if top2 else 48,
                              dtype=DTYPES[dtype][0], **kw)
    return jp, from_jax_params(jp, "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_routing(params, x, top_k, capacity_factor):
    """The reference's expert ids and keep mask, its own lines run."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    g = jmoe._pick_groups(b * s, 16)
    tg = b * s // g
    probs = jax.nn.softmax(x.reshape(g, tg, d).astype(jnp.float32)
                           @ params["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, top_k)
    tk = tg * top_k
    cap = max(1, int(tk * capacity_factor / e))
    sorted_e = jnp.sort(expert_ids.reshape(g, tk), axis=-1)
    starts = jax.vmap(
        lambda se: jnp.searchsorted(se, jnp.arange(e), side="left")
    )(sorted_e)
    pos_in_e = jnp.arange(tk)[None] - jnp.take_along_axis(
        starts, sorted_e, axis=-1)
    return np.asarray(expert_ids), np.asarray(pos_in_e < cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_top6_matches_reference(dtype, capacity_factor):
    """Top-6 over 16 experts beside 2 shared experts, 2 x 48 tokens in 16
    groups of 6: the chosen experts and the keep mask copy for copy, the
    outputs, the auxiliaries, and the gradients of ``sum(y * c) +
    load_balance + router_z`` with respect to every parameter and the
    input, against the reference on its weights; two runs give the same
    bits, gradients included."""
    jp, tp = _moe_pair(dtype)
    x, c = _x(2, (2, 48, 64)), _x(3, (2, 48, 64))
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jdt)

    j_ids, j_keep = _jax_routing(jp, jx, TOP_K, capacity_factor)
    _, _, gate_vals, ids = tmoe.route(tp["router"],
                                      _t(x).to(tdt).reshape(16, 6, 64),
                                      TOP_K)
    cap = tmoe.capacity(6, TOP_K, E, capacity_factor)
    _, keep, _, _ = tmoe.dispatch(ids, gate_vals, E, cap)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_array_equal(keep.numpy(), j_keep)

    def jloss_fn(p, x):
        y, aux = jmoe.moe_forward(p, x, top_k=TOP_K,
                                  capacity_factor=capacity_factor)
        return (jnp.sum(y.astype(jnp.float32) * c) + aux["load_balance"]
                + aux["router_z"]), (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss_fn, argnums=(0, 1), has_aux=True))(jp, jx)

    def run():
        p = {k: v.detach().clone().requires_grad_(True)
             if isinstance(v, torch.Tensor) else
             {kk: vv.detach().clone().requires_grad_(True)
              for kk, vv in v.items()} for k, v in tp.items()}
        tx = _t(x).to(tdt).requires_grad_(True)
        y, aux = tmoe.moe_forward(p, tx, top_k=TOP_K,
                                  capacity_factor=capacity_factor)
        (y.float() * _t(c)).sum().add(
            aux["load_balance"] + aux["router_z"]).backward()
        return y, aux, tx.grad, p

    y, aux, gx, gp = run()
    y2, _, gx2, gp2 = run()
    assert torch.equal(y, y2) and torch.equal(gx, gx2)
    assert (float(aux["drop_fraction"]) > 0) == (capacity_factor == 1.25)

    def close(t, j, what):
        j = np.asarray(j, np.float32)
        scale = float(np.abs(j).max()) or 1.0
        np.testing.assert_allclose(t.detach().float().numpy(), j,
                                   atol=MOE_ATOL[dtype] * scale,
                                   err_msg=what)

    close(y, jy, "y")
    for k in ("load_balance", "router_z", "drop_fraction"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=AUX_ATOL, atol=1e-7, err_msg=k)
    close(gx, jgx, "dx")
    for k, v in gp.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            g2 = gp2[k][kk] if kk else gp2[k]
            ref = jgp[k][kk] if kk else jgp[k]
            assert torch.equal(vv.grad, g2.grad), (k, kk)
            close(vv.grad, ref, f"d{k}/{kk}")


def _index_add_combine(params, x, top_k, capacity_factor):
    """``moe_forward`` with the combine it had before: the copies summed
    onto zero by ``index_add`` in sorted order (the rest its own code)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    g = tmoe._pick_groups(t)
    tg = t // g
    xg = x.reshape(g, tg, d)
    _, _, gate_vals, expert_ids = tmoe.route(params["router"], xg, top_k)
    cap = tmoe.capacity(tg, top_k, e, capacity_factor)
    slot, keep, order, sorted_g = tmoe.dispatch(expert_ids, gate_vals, e,
                                                cap)
    sorted_tok = order // top_k
    rows = torch.gather(xg, 1, sorted_tok[..., None].expand(-1, -1, d))
    buf = xg.new_zeros((g, e * cap + 1, d)).scatter(
        1, slot[..., None].expand(-1, -1, d), rows)
    xe = buf[:, :-1].reshape(g, e, cap, d).transpose(0, 1).reshape(
        e, g * cap, d)
    gate = torch.nn.functional.silu(xe @ params["w_gate"].to(x.dtype))
    he = (gate * (xe @ params["w_up"].to(x.dtype))) \
        @ params["w_down"].to(x.dtype)
    he = he.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    out_rows = torch.cat([he, he.new_zeros((g, 1, d))], dim=1)
    contrib = torch.gather(out_rows, 1, slot[..., None].expand(-1, -1, d)) \
        * (sorted_g * keep).to(x.dtype)[..., None]
    flat_tok = sorted_tok + tg * torch.arange(g)[:, None]
    y = x.new_zeros((t, d)).index_add(0, flat_tok.reshape(-1),
                                      contrib.reshape(-1, d))
    if "shared" in params:
        y = y + tmoe.swiglu_forward(params["shared"], x.reshape(t, d))
    if "dense_residual" in params:
        y = y + tmoe.swiglu_forward(params["dense_residual"],
                                    x.reshape(t, d))
    return y.reshape(b, s, d)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_keeps_the_top2_bits(dtype, capacity_factor):
    """At top-2 (arctic) the per-token combine gives exactly the bits of
    the ``index_add`` combine it replaced, with a dense residual as arctic
    has.  At top-6 in fp32 it gives the bits of the CPU's ``index_add``,
    which adds the sorted copies one at a time in their order, as the new
    combine does (in bf16 the CPU's ``index_add`` rounds otherwise)."""
    _, tp = _moe_pair(dtype, 8, top2=True)
    x = _t(_x(5, (2, 48, 64))).to(DTYPES[dtype][1])
    y, _ = tmoe.moe_forward(tp, x, top_k=2, capacity_factor=capacity_factor)
    assert torch.equal(y, _index_add_combine(tp, x, 2, capacity_factor))
    if dtype == "float32":
        _, tp6 = _moe_pair(dtype)
        y6, _ = tmoe.moe_forward(tp6, x, top_k=TOP_K,
                                 capacity_factor=capacity_factor)
        assert torch.equal(y6, _index_add_combine(tp6, x, TOP_K,
                                                  capacity_factor))


# ---------------------------------------------------------------------------
# the whole model: 3 layers, a dense segment and a moe segment on the client
# ---------------------------------------------------------------------------

def _cut3(cfg):
    """``reduced()`` cut to 3 layers with 16 experts at top-6 beside 2
    shared experts, the split after layer 2: client (dense, 1), (moe, 1);
    server (moe, 1)."""
    return dataclasses.replace(
        cfg.reduced(), n_layers=3, n_experts=E, moe_top_k=TOP_K,
        n_shared_experts=SHARED,
        split=dataclasses.replace(cfg.split, cut_layer=2))


@functools.lru_cache(maxsize=None)
def _setup():
    cfg, tcfg = _cut3(get_config("deepseek_v2_236b")), \
        _cut3(tget("deepseek_v2_236b"))
    jp = jax.jit(functools.partial(jtf.init_params, cfg=cfg))(KEY)
    return cfg, tcfg, jp, from_jax_params(jp, "cpu")


def _tokens(cfg, b=2, plen=24, seed=11):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, plen)).astype(np.int32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_config_and_segments_match_reference():
    """The full config and the 3-layer cut field for field; the full
    stack's dense layer 0 then 59 moe layers cut at 30; the cut's client
    of a dense and a moe segment; MLA at (192, 128), G 1."""
    full, tfull = get_config("deepseek_v2_236b"), tget("deepseek-v2-236b")
    assert dataclasses.asdict(tfull) == dataclasses.asdict(full)
    assert tfull.block_pattern() == ("dense",) + ("moe",) * 59
    assert tfull.client_server_segments() == (
        (("dense", 1), ("moe", 29)), (("moe", 30),))
    assert (tfull.qk_nope_dim + tfull.qk_rope_dim, tfull.v_head_dim,
            tfull.n_heads // tfull.n_kv_heads) == (D, DV, 1)
    cfg, tcfg, _, _ = _setup()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.client_server_segments() == cfg.client_server_segments() \
        == ((("dense", 1), ("moe", 1)), (("moe", 1),))


def test_segment_trees_and_bridge():
    """Each segment keeps the reference's tree: the dense segment a SwiGLU
    of width d_ff, a moe segment 16 experts of width moe_d_ff, a router
    and a shared SwiGLU of 2 x moe_d_ff; ``init_params`` gives the
    reference's shapes, and ``from_jax_params`` carries every leaf across
    unchanged."""
    cfg, tcfg, jp, tp = _setup()
    port = ttf.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(port) == _shapes(jp) == _shapes(tp)
    d, f = tcfg.d_model, tcfg.moe_d_ff
    dense = port["client"]["seg0"]["ffn"]
    moe = port["client"]["seg1"]["ffn"]
    assert set(dense) == {"w_gate", "w_up", "w_down"}
    assert dense["w_gate"].shape == (1, d, tcfg.d_ff)
    assert moe["w_gate"].shape == (1, E, d, f)
    assert moe["router"].shape == (1, d, E)
    assert moe["shared"]["w_up"].shape == (1, d, SHARED * f)
    assert set(port["server"]["seg0"]["ffn"]) == set(moe)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for p, leaf in flat:
        node = tp
        for k in p:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_forward_and_latent_caches_match_reference():
    """Logits, the auxiliaries (summed over the two moe layers; the dense
    layer adds zeros) and every segment's latent cache (ckv, krope, pos)
    of a prefill into a ring of 40 slots."""
    cfg, tcfg, jp, tp = _setup()
    toks = _tokens(cfg)
    jl, jaux, jc = jax.jit(functools.partial(
        jtf.forward, cfg=cfg, collect_cache=40))(
            jp, batch=dict(tokens=jnp.asarray(toks)))
    tl, taux, tc = ttf.forward(tp, tcfg, dict(tokens=_t(toks)),
                               collect_cache=40)
    _close(tl, jl)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(taux["drop_fraction"]) > 0
    for side in ("client", "server"):
        assert tc[side].keys() == jc[side].keys()
        for seg in jc[side]:
            assert tc[side][seg].keys() == {"ckv", "krope", "pos"}
            for leaf, val in tc[side][seg].items():
                if leaf == "pos":
                    np.testing.assert_array_equal(
                        val.numpy(), np.asarray(jc[side][seg][leaf]))
                else:
                    _close(val, jc[side][seg][leaf])


def test_generate_token_exact_vs_reference():
    """Greedy ``generate``, prefill included, 8 new tokens, token for token
    against the reference's (a ring of 40 slots)."""
    cfg, tcfg, jp, tp = _setup()
    toks = _tokens(cfg, b=3, plen=12, seed=12)
    ref = np.asarray(jsd.generate(jp, cfg, dict(tokens=jnp.asarray(toks)),
                                  n_new=8, cache_len=40))
    out = tsd.generate(tp, tcfg, dict(tokens=_t(toks)), n_new=8,
                       cache_len=40).numpy()
    assert out.shape == (3, 8)
    np.testing.assert_array_equal(out, ref)


def _leaves(tree):
    if any(isinstance(x, torch.Tensor)
           for _, x in tree_flatten_with_path(tree)):
        return {"/".join(p): x.detach().float().numpy()
                for p, x in tree_flatten_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(x, np.float32)
            for p, x in flat}


def test_train_step_loss_and_grads_match_reference():
    """One training step's composite loss and every gradient leaf, the
    dense segment's and both moe segments' included, on a batch of 2 x 24
    tokens of the data pipeline: loss / ce / commit within rtol 1e-5,
    every leaf within 1e-4 of its max |leaf| plus 1e-6
    (tests/test_torch_train.py's)."""
    cfg, tcfg, jp, tp = _setup()
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
    assert any(k.startswith("client/seg1/ffn/shared") for k in tl)
    for k in jl:
        tol = 1e-4 * float(np.abs(jl[k]).max()) + 1e-6
        np.testing.assert_allclose(tl[k], jl[k], atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# launchers, refusals and the smoke runner
# ---------------------------------------------------------------------------

def test_launchers_run_at_reduced(capsys):
    """``launch.train`` and ``launch.serve_batched`` (prefill and
    ``generate``) at ``reduced()`` on the CPU; ``--engine`` raises, as for
    every MLA config (paged serving needs GQA KV caches)."""
    from repro_torch.launch import serve_batched, train

    train.main(["--device", "cpu", "--arch", "deepseek_v2_236b", "--steps",
                "2", "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2
    serve_batched.main(["--device", "cpu", "--arch", "deepseek-v2-236b",
                        "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill(2x5)" in out and "decoded 3 tokens" in out
    with pytest.raises(NotImplementedError, match="GQA"):
        serve_batched.main(["--device", "cpu", "--arch", "deepseek_v2_236b",
                            "--engine", "--batch", "2", "--prompt-len", "5",
                            "--new-tokens", "3"])


def test_other_block_types_still_raise():
    """The stack takes dense and moe blocks together, mamba2 /
    shared_attn (zamba2_2_7b), rwkv6 (rwkv6_7b) and the audio modality
    (musicgen_large): ``_check_supported`` accepts every arch of the
    reference's."""
    for arch in ("deepseek_v2_236b", "zamba2_2_7b", "rwkv6_7b",
                 "musicgen_large"):
        ttf._check_supported(tget(arch))
        ttf._check_supported(get_config(arch))


def test_smoke_runner_imports_neither_jax_nor_repro():
    """``scripts/smoke_phases.py`` imports neither ``jax`` nor ``repro``,
    and names every phase it can run among ``chip_smoke.py``'s
    functions."""
    path = ROOT / "scripts" / "smoke_phases.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = [a.name for a in node.names] \
            if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        assert not any(n.split(".")[0] in ("jax", "repro") for n in names)
    smoke = {n.name for n in ast.parse(
        (ROOT / "chip_smoke.py").read_text()).body
        if isinstance(n, ast.FunctionDef)}
    assert {"phase_deepseek_serve", "phase_deepseek_train"} <= smoke
