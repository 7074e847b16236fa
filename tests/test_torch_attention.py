"""The port's attention (kernels K1, K2 / K3 and K8, and the layers around
them) against the JAX reference, on the CPU, in fp32, K1 - K3 at head
width 16 and 128; the launch plans of K2 / K3 (at the compiled widths 64
and 128) and of K6 - K9; the wrappers' refusals of widths the kernels are
not compiled for; and a plain model of the decode kernels' split of a
row's pages (a slot's table row, or a ring row's virtual pages) over a
cluster's ranks."""
from collections import Counter

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import attention_ops as jops  # noqa: E402
from repro.kernels import attention_ref as jref  # noqa: E402
from repro.kernels import decode_kernel  # noqa: E402
from repro.kernels import flash_kernel  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402
from repro_torch.kernels import attention_ref as tref  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402

ATOL = 1e-5
FAR = 2 ** 30


def _t(a):
    return torch.as_tensor(np.array(a))


def _qkv(b, sq, h, kh, d, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, kh, d)).astype(np.float32),
            rng.normal(size=(b, skv, kh, d)).astype(np.float32))


# (sq, skv, h, kh, window, kv_valid_len, chunk); padded tails: sq or skv
# not a multiple of the chunk
FLASH_CASES = [
    (48, 48, 4, 4, None, None, 16),   # causal
    (48, 48, 4, 2, None, None, 16),   # GQA
    (40, 40, 4, 2, None, None, 16),   # padded q / kv tail
    (32, 48, 4, 2, None, 24, 16),     # kv_valid_len + longer kv
    (48, 48, 4, 2, 12, None, 16),     # window
    (48, 48, 6, 2, None, None, 16),   # G = 3 (K3's clusters of 3)
]


# the head width of the FLASH_CASES checks; D128_CASES run them at the
# width of llama3_2_3b, which K1 - K3 are compiled for on the card
D = 16
D128_CASES = [FLASH_CASES[i] for i in (1, 2, 3, 4, 5)]
# and at zamba2_2_7b's 80 (G 1 as zamba2's, a padded tail, kv_valid_len,
# a window), which K1 - K3 keep 96 columns wide on the card
D80_CASES = [FLASH_CASES[i] for i in (0, 2, 3, 4)]


def _atol(d, ref):
    """ATOL at D 16; at D 128 (or 80), where every sum runs over 8x (5x)
    the terms and the gradients reach ~10, ATOL relative to the largest
    |ref|."""
    return ATOL if d == D else ATOL * max(1.0, float(np.abs(ref).max()))


def _operands(sq, skv, h, kh, window, kv_valid_len, chunk, seed=0, d=D):
    """Pre-scaled, chunk-padded operands with sentinel positions, built as
    the reference's flash_attention builds them."""
    q, k, v = _qkv(1, sq, h, kh, d, seed, skv)
    pad_q, pad_kv = (-sq) % chunk, (-skv) % chunk
    qs = np.pad(q * d ** -0.5, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
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


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_plain_matches_reference_kernel(case):
    """(out, m, l) of the plain K1 against the Pallas kernel in interpret
    mode and the jnp reference, on every row that sees a key.  A row that
    sees none (a padded q row) is 0 with l = 0 in the port; the reference
    leaves a block-size-dependent value there (ROADMAP queue F)."""
    _check_flash_forward(case, D)


@pytest.mark.parametrize("case", D128_CASES)
def test_flash_forward_plain_matches_reference_kernel_d128(case):
    """As above at head width 128 (GQA, padded tails, kv_valid_len, a
    window, G = 3)."""
    _check_flash_forward(case, 128)


@pytest.mark.parametrize("case", D80_CASES)
def test_flash_forward_plain_matches_reference_kernel_d80(case):
    """As above at head width 80 (zamba2_2_7b's)."""
    _check_flash_forward(case, 80)


def _check_flash_forward(case, d):
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case, d=d)
    bhsd = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa
    jo, jm, jl = flash_kernel.forward(
        jnp.asarray(bhsd(qs)), jnp.asarray(bhsd(k)), jnp.asarray(bhsd(v)),
        jnp.asarray(qpos.reshape(-1, 1)), jnp.asarray(kpos.reshape(1, -1)),
        window=window, block=chunk, interpret=True)
    to, tm, tl = tops.flash_forward(_t(bhsd(qs)), _t(bhsd(k)), _t(bhsd(v)),
                                    _t(qpos), _t(kpos), window=window)
    seen = np.asarray(tl)[..., 0] > 0
    assert seen[:, :, :sq].all() and not seen[:, :, sq:].any()
    np.testing.assert_allclose(to.numpy()[seen], np.asarray(jo)[seen],
                               atol=_atol(d, jo))
    np.testing.assert_allclose(tm.numpy()[seen], np.asarray(jm)[seen],
                               atol=_atol(d, jm))
    np.testing.assert_allclose(tl.numpy()[seen], np.asarray(jl)[seen],
                               rtol=ATOL)
    assert np.all(to.numpy()[~seen] == 0) and np.all(tl.numpy()[~seen] == 0)
    jr = jref.flash_reference(jnp.asarray(qs), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(qpos),
                              jnp.asarray(kpos), window, chunk)
    port = tops.flash(_t(qs), _t(k), _t(v), _t(qpos), _t(kpos), window)
    np.testing.assert_allclose(port.numpy()[:, :sq], np.asarray(jr)[:, :sq],
                               atol=_atol(d, jr))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    sq, skv, h, kh, window, kvl, chunk = case
    q, k, v = _qkv(2, sq, h, kh, 16, seed=1, skv=skv)
    kw = dict(window=window, kv_valid_len=kvl, q_chunk=chunk, kv_chunk=chunk)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), impl="pallas", **kw)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_gqa_forward_matches_reference():
    rng = np.random.default_rng(2)
    dm, h, kh, hd, s = 64, 4, 2, 16, 24
    p = {k: (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
         for k, shape in (("wq", (dm, h * hd)), ("wk", (dm, kh * hd)),
                          ("wv", (dm, kh * hd)), ("wo", (h * hd, dm)))}
    x = rng.normal(size=(2, s, dm)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, rope_theta=1e4,
              return_kv=True)
    jy, (jk, jv) = jattn.gqa_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos), **kw)
    ty, (tk, tv) = tattn.gqa_forward({k: _t(v) for k, v in p.items()},
                                     _t(x), positions=_t(pos), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def _bhsd(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_plain_matches_reference_kernels(case):
    """dq / dk / dv of the plain K2 / K3 against the Pallas backward_dq /
    backward_dkv in interpret mode and the jnp VJP of flash_reference,
    all fed the JAX forward's own (m, l) and di.  Rows that see no key
    (padded q rows) get a zero output gradient, as flash_attention gives
    them; there the reference's P is not 0 (attention_ref docstring)."""
    _check_flash_backward(case, D)


@pytest.mark.parametrize("case", D128_CASES)
def test_flash_backward_plain_matches_reference_kernels_d128(case):
    """As above at head width 128."""
    _check_flash_backward(case, 128)


@pytest.mark.parametrize("case", D80_CASES)
def test_flash_backward_plain_matches_reference_kernels_d80(case):
    """As above at head width 80."""
    _check_flash_backward(case, 80)


def _check_flash_backward(case, d):
    sq, skv, h, kh, window, kvl, chunk = case
    qs, k, v, qpos, kpos = _operands(*case, d=d)
    rng = np.random.default_rng(5)
    go = rng.normal(size=qs.shape).astype(np.float32)  # (B, S, H, D)
    go[:, sq:] = 0.0
    jq, jk, jv = (jnp.asarray(_bhsd(a)) for a in (qs, k, v))
    jqp, jkp = jnp.asarray(qpos.reshape(-1, 1)), jnp.asarray(
        kpos.reshape(1, -1))
    jo, jm, jl = flash_kernel.forward(jq, jk, jv, jqp, jkp, window=window,
                                      block=chunk, interpret=True)
    gob = _bhsd(go)
    di = np.sum(gob * np.asarray(jo), axis=-1, keepdims=True)
    kw = dict(window=window, block=chunk, interpret=True)
    jdq = flash_kernel.backward_dq(jq, jk, jv, jnp.asarray(gob), jm, jl,
                                   jnp.asarray(di), jqp, jkp, **kw)
    jdk, jdv = flash_kernel.backward_dkv(jq, jk, jv, jnp.asarray(gob), jm,
                                         jl, jnp.asarray(di), jqp, jkp, **kw)
    targs = [_t(_bhsd(a)) for a in (qs, k, v)] + [_t(gob), _t(jm), _t(jl),
                                                   _t(di), _t(qpos),
                                                   _t(kpos)]
    dq, dk, dv = tref.flash_backward_ref(*targs, window=window)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   atol=_atol(d, ref))
    # the wrappers run the same plain version on CPU tensors
    np.testing.assert_array_equal(
        tops.flash_backward_dq(*targs, window=window).numpy(), dq.numpy())
    wk, wv = tops.flash_backward_dkv(*targs, window=window)
    np.testing.assert_array_equal(wk.numpy(), dk.numpy())
    np.testing.assert_array_equal(wv.numpy(), dv.numpy())
    # the jnp custom VJP, in (B, S, H, D) layout
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_reference(
        a, b_, c, jnp.asarray(qpos), jnp.asarray(kpos), window, chunk),
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))
    rq, rk, rv = vjp(jnp.asarray(go))
    for port, ref in ((dq, rq), (dk, rk), (dv, rv)):
        np.testing.assert_allclose(_bhsd(port.numpy()), np.asarray(ref),
                                   atol=_atol(d, ref))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_grads_match_reference(case):
    """torch.autograd.grad through the port's flash_attention (the
    FlashAttention Function, K2 / K3's plain version on the CPU) against
    jax.grad through the reference's with its jnp custom VJP (the Pallas
    backward is held above)."""
    sq, skv, h, kh, window, kvl, chunk = case
    q, k, v = _qkv(2, sq, h, kh, 16, seed=3, skv=skv)
    w = np.random.default_rng(4).normal(size=(2, sq, h, 16)).astype(
        np.float32)
    kw = dict(window=window, kv_valid_len=kvl, q_chunk=chunk, kv_chunk=chunk)
    jg = jax.grad(lambda a, b_, c: jnp.sum(jattn.flash_attention(
        a, b_, c, impl="jnp", **kw) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, **kw)
    tg = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for port, ref in zip(tg, jg):
        assert port.shape == ref.shape and port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_function_gradcheck(window):
    """FlashAttention in fp64 on the CPU against finite differences, with
    GQA, a padded q row (qpos -2^30: it sees no key) and a padded key."""
    rng = np.random.default_rng(6)
    b, s, h, kh, d = 1, 8, 2, 1, 4
    qs, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float64,
                             requires_grad=True)
                for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    qpos = torch.tensor(list(range(s - 1)) + [-FAR], dtype=torch.int32)
    kpos = torch.tensor(list(range(s - 1)) + [FAR], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b_, c: tops.FlashAttention.apply(a, b_, c, qpos, kpos,
                                                   window),
        (qs, k, v), eps=1e-6, atol=1e-6)


# (b, h, kh, sq, skv) of K2 / K3's launch plans: tinyllava's training
# shape, llama's grouping (G = 3), G = 1, G = 16 (clusters of 8, two heads
# a block) and ragged tiles
PLAN_SHAPES = [(4, 20, 5, 1024, 1024), (2, 24, 8, 1024, 1024),
               (2, 16, 16, 512, 512), (1, 32, 2, 1024, 1024),
               (1, 20, 5, 100, 100)]
# the same shapes at each compiled head width: (b, h, kh, sq, skv, hd)
PLAN_SHAPES_HD = [s + (64,) for s in PLAN_SHAPES] \
    + [s + (128,) for s in PLAN_SHAPES]


def _plan_blocks(b, h, kh, sq, skv, hd=64):
    """The (tile, query head, batch row) items each block of K2 and of K3
    takes, in order, blocks in launch order (grid x fastest), as the
    kernels map blockIdx from the plan (csrc/flash_bwd.cu)."""
    dq, dkv = tops.flash_bwd_plan(b, h, kh, sq, skv, hd)
    g, p = h // kh, len(dq.heads[0])
    dq_blocks = [[(dq.tiles[y], x % (h // p) * p + j, x // (h // p))
                  for j in dq.heads[0]]
                 for y in range(dq.grid[1]) for x in range(dq.grid[0])]
    dkv_blocks = []
    for y in range(dkv.grid[1]):
        for x in range(dkv.grid[0]):
            rank, grp = x % dkv.cluster, x // dkv.cluster
            dkv_blocks.append([(dkv.tiles[y], (grp % kh) * g + i, grp // kh)
                               for i in dkv.heads[rank]])
    return dq_blocks, dkv_blocks


@pytest.mark.parametrize("shape", PLAN_SHAPES_HD)
def test_flash_bwd_plan_covers_every_tile_once(shape):
    """K2's blocks take every (q tile of 128 rows, head, batch row) once and
    K3's every (kv tile of 128 keys, query head, batch row) once; the
    blocks of a K3 cluster share one (kv tile, kv head, batch row), each
    sweeping its heads in increasing order.  At head widths 64 and 128."""
    b, h, kh, sq, skv, hd = shape
    dq, dkv = tops.flash_bwd_plan(*shape)
    dq_blocks, dkv_blocks = _plan_blocks(*shape)
    assert len(dq_blocks) == dq.grid[0] * dq.grid[1]
    assert len(dkv_blocks) == dkv.grid[0] * dkv.grid[1]
    every = lambda n_tiles: Counter(  # noqa: E731
        (t, hh, bb) for t in range(n_tiles) for hh in range(h)
        for bb in range(b))
    assert Counter(i for blk in dq_blocks for i in blk) == every(-(-sq // 128))
    assert Counter(i for blk in dkv_blocks for i in blk) \
        == every(-(-skv // 128))
    g, c = h // kh, dkv.cluster
    for j in range(0, len(dkv_blocks), c):
        cluster = dkv_blocks[j:j + c]
        assert len({(t, hh // g, bb) for blk in cluster
                    for t, hh, bb in blk}) == 1
        assert all([hh for _, hh, _ in blk] == sorted(hh for _, hh, _ in blk)
                   for blk in cluster)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_flash_bwd_plan_cluster_divides_group(shape):
    """Each kernel's blocks sweep p heads of one GQA group, p a divisor of
    G: the most whose longest sweep (p n tiles of 64 positions) stays within
    the causal work per SM, B H n^2 / (4 x 132) tiles.  K3's cluster of
    c = G / p blocks is at most 8; its ranks split the group's heads."""
    b, h, kh, sq, skv = shape
    g = h // kh
    dq, dkv = tops.flash_bwd_plan(*shape)

    def rule(n, limit):
        allowed = [p for p in range(1, g + 1)
                   if g % p == 0 and g // p <= limit]
        fits = [p for p in allowed if p * n * 4 * 132 <= b * h * n * n]
        return max(fits) if fits else min(allowed)

    assert dq.cluster == 1 and len(dq.heads) == 1
    assert dq.heads[0] == tuple(range(rule(-(-skv // 64), g)))
    c = dkv.cluster
    assert 1 <= c <= 8 and g % c == 0 and g // c == rule(-(-sq // 64), 8)
    assert [hh for hs in dkv.heads for hh in hs] == list(range(g))
    assert all(len(hs) == g // c for hs in dkv.heads)
    if shape == (4, 20, 5, 1024, 1024):  # the training shape: 2 heads a block
        assert len(dq.heads[0]) == 2 and c == 2


@pytest.mark.parametrize("shape", PLAN_SHAPES_HD)
def test_flash_bwd_plan_fits_shared_memory(shape):
    """Both kernels' dynamic shared memory fits a block on the H100 (227
    KB), at the shape and at a 32k sequence (the visible-tile list grows
    with it), at head widths 64 and 128 (K2 keeps 2 ring stages at 128)."""
    b, h, kh, sq, skv, hd = shape
    for plan in tops.flash_bwd_plan(*shape) + tops.flash_bwd_plan(
            b, h, kh, 32768, 32768, hd):
        assert 48 * 1024 < plan.smem <= tops.SMEM_MAX == 232448


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_flash_bwd_plan_shared_memory_at_each_width(shape):
    """The plans' shared memory is the kernels' layout (csrc/flash_bwd.cu,
    DqSmem / DkvSmem) at each width: K2 two Q / dO slots of 128 rows and a
    ring of 3 (64) or 2 (128) K / V stages of 64 keys, K3 the K / V tiles
    of 128 keys, 3 stages of Q / dO tiles of 64 rows and their row
    statistics; both the mbarriers, 32 bytes of scratch and the tile
    list.  The grid and the heads do not depend on the width."""
    b, h, kh, sq, skv = shape
    nkv64, nq64 = -(-skv // 64), -(-sq // 64)
    for hd, stages in ((64, 3), (128, 2)):
        dq, dkv = tops.flash_bwd_plan(b, h, kh, sq, skv, hd)
        assert dq.smem == 1024 + 4 * 128 * hd * 2 + 2 * stages * 64 * hd * 2 \
            + (4 + 2 * stages) * 8 + 32 + nkv64 * 4
        assert dkv.smem == 1024 + (2 * 128 + 6 * 64) * hd * 2 \
            + 3 * 3 * 64 * 4 + 7 * 8 + 32 + nq64 * 4
        assert (dq.grid, dq.heads, dkv.grid, dkv.heads) == (
            tops.flash_bwd_plan(*shape)[0].grid,
            tops.flash_bwd_plan(*shape)[0].heads,
            tops.flash_bwd_plan(*shape)[1].grid,
            tops.flash_bwd_plan(*shape)[1].heads)


def test_flash_wrappers_refuse_other_widths():
    """CUDA-free argument checks: K1 - K3 take (D, Dv) in (64, 64),
    (128, 128), MLA's (96, 64) and zamba2's (80, 80), refuse 96 / 96,
    (128, 64) and (112, 112), the last saying no ROADMAP item queues it;
    the plan refuses other widths; the decode kernels K6 - K9 take 64, 128
    and 80 and refuse 96, saying no item queues it."""
    def ops(d, dv=None):
        q = torch.zeros(1, 4, 16, d, dtype=torch.bfloat16)
        k = torch.zeros(1, 2, 16, d, dtype=torch.bfloat16)
        v = torch.zeros(1, 2, 16, d if dv is None else dv,
                        dtype=torch.bfloat16)
        pos = torch.arange(16, dtype=torch.int32)
        return q, k, v, pos, pos

    for d, dv in ((64, None), (128, None), (96, 64), (80, 80)):
        qpos, _ = tops._check_flash("K1", *ops(d, dv))
        assert qpos.dtype == torch.int32
    tops.flash_bwd_plan(1, 4, 2, 16, 16, 96, 64)
    tops.flash_bwd_plan(1, 4, 2, 16, 16, 80, 80)
    with pytest.raises(ValueError, match="head_dim"):
        tops._check_flash("K1", *ops(96))
    with pytest.raises(ValueError, match="head_dim"):
        tops._check_flash("K1", *ops(128, dv=64))
    with pytest.raises(ValueError, match="no ROADMAP item"):
        tops._check_flash("K1", *ops(112, dv=112))
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_bwd_plan(1, 4, 2, 16, 16, 96)
    for d in (64, 128, 80, 96):
        qf = torch.zeros(2, 2, 2, d, dtype=torch.bfloat16)
        cache = torch.zeros(2, 8, 2, d, dtype=torch.bfloat16)
        pos = torch.zeros(2, 8, dtype=torch.int32)
        qpos = torch.zeros(2, dtype=torch.int32)
        if d in tops.DECODE_HEAD_DIMS:
            tops._check_decode("K6", qf, cache, cache, (), pos, qpos,
                               torch.bfloat16)
        else:
            with pytest.raises(ValueError, match="no ROADMAP item"):
                tops._check_decode("K6", qf, cache, cache, (), pos, qpos,
                                   torch.bfloat16)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_flash_bwd_plan_runs_longest_first(shape):
    """Under causal positions (query i sees keys <= i) the tiles a block
    must sweep never grow along the launch order: K2's last q tile first,
    K3's kv tile 0 first."""
    b, h, kh, sq, skv = shape
    dq_blocks, dkv_blocks = _plan_blocks(*shape)

    def dq_work(tile):  # kv tiles of 64 keys its last row sees
        last = min((tile + 1) * 128, sq) - 1
        return min(last // 64 + 1, -(-skv // 64))

    def dkv_work(tile):  # q tiles of 64 rows that see its first key
        first = tile * 128
        return max(0, -(-sq // 64) - first // 64) if first < sq else 0

    for blocks, work in ((dq_blocks, dq_work), (dkv_blocks, dkv_work)):
        seq = [sum(work(t) for t, _, _ in blk) for blk in blocks]
        assert seq == sorted(seq, reverse=True) and seq[0] > 0


def _paged_fixture():
    """The reference's own paged fixture: slot 0 has a -1 page, slot 2 is
    inactive (qpos = -1, no pages)."""
    rng = np.random.default_rng(0)
    p, pg, kh, g, d = 7, 8, 2, 2, 16
    pt = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1]], np.int32)
    qpos = np.array([12, 21, -1], np.int32)
    pos = np.full((p, pg), -1, np.int32)
    pos[1] = np.arange(pg)
    pos[2] = np.arange(pg, 2 * pg)
    pos[2, 5:] = -1
    for j in range(3):
        pos[3 + j] = np.arange(j * pg, (j + 1) * pg)
    qf = (rng.normal(size=(3, kh, g, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.normal(size=(p, pg, kh, d)).astype(np.float32)
    v = rng.normal(size=(p, pg, kh, d)).astype(np.float32)
    return qf, k, v, pos, pt, qpos


@pytest.mark.parametrize("window", [None, 6])
def test_decode_paged_plain_matches_reference(window):
    qf, k, v, pos, pt, qpos = _paged_fixture()
    jargs = [jnp.asarray(a) for a in (qf, k, v, pos, pt, qpos)]
    jk = jops.decode_paged_pallas(*jargs, window=window)  # interpret mode
    jr = jref.decode_attention_paged_ref(*jargs, window=window)
    out = tops.decode_paged(*[_t(a) for a in (qf, k, v, pos, pt, qpos)],
                            window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), atol=ATOL)
    assert np.all(out.numpy()[2] == 0.0)  # inactive slot: exact zero


def test_gather_pages_and_kpos_match_reference():
    _, k, _, pos, pt, _ = _paged_fixture()
    np.testing.assert_array_equal(
        tref.gather_pages(_t(k), _t(pt)).numpy(),
        np.asarray(jref.gather_pages(jnp.asarray(k), jnp.asarray(pt))))
    np.testing.assert_array_equal(
        tref.paged_kpos(_t(pos), _t(pt)).numpy(),
        np.asarray(jref.paged_kpos(jnp.asarray(pos), jnp.asarray(pt))))


def test_gqa_decode_paged_pool_writes_match_reference():
    """Several ticks with one inactive slot: outputs and every pool leaf,
    trash page included, match the reference's functional update."""
    rng = np.random.default_rng(3)
    s, h, kh, d, dm, pg, npp = 3, 4, 2, 16, 32, 4, 3
    p = {k: (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
         for k, shape in (("wq", (dm, h * d)), ("wk", (dm, kh * d)),
                          ("wv", (dm, kh * d)), ("wo", (h * d, dm)))}
    pt = np.array([[1, 2, 3], [4, 5, -1], [-1, -1, -1]], np.int32)
    jpool = jattn.init_paged_kv_pool(6, pg, kh, d, dtype=jnp.float32)
    tpool = tattn.init_paged_kv_pool(6, pg, kh, d, dtype=torch.float32,
                                     device="cpu")
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=d, rope_theta=1e4)
    for t in range(7):
        x = rng.normal(size=(s, 1, dm)).astype(np.float32)
        qpos = np.array([t, t if t < 6 else -1, -1], np.int32)
        jy, jpool = jattn.gqa_decode_paged(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jpool, qpos=jnp.asarray(qpos), page_table=jnp.asarray(pt), **kw)
        ty, tpool = tattn.gqa_decode_paged(
            {k: _t(v) for k, v in p.items()}, _t(x), tpool, qpos=_t(qpos),
            page_table=_t(pt), **kw)
        np.testing.assert_allclose(ty.numpy()[:2], np.asarray(jy)[:2],
                                   atol=ATOL)
        np.testing.assert_array_equal(tpool["pos"].numpy(),
                                      np.asarray(jpool["pos"]))
        for leaf in ("k", "v"):  # the trash page holds only garbage
            np.testing.assert_allclose(tpool[leaf].numpy()[1:],
                                       np.asarray(jpool[leaf])[1:],
                                       atol=ATOL)
    assert np.all(tpool["pos"].numpy()[0] == -1)


# ---------------------------------------------------------------------------
# K8 / K9: the launch plan and a plain model of the split over the cluster
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_KV_HEADS = 4, 5
PAGED_PLAN_SHAPES = [(npp, pg, g) for npp in (1, 2, 64, 128)
                     for pg in (8, 16, 64) for g in (1, 4, 16)]


def _rank_pages(plan, npp):
    return [list(range(r * plan.pages_per_rank,
                       min(npp, (r + 1) * plan.pages_per_rank)))
            for r in range(plan.cluster)]


@pytest.mark.parametrize("shape", PAGED_PLAN_SHAPES)
def test_decode_paged_plan_covers_every_page_once(shape):
    """The ranks of a cluster (a power of two, at most 8 and at most npp)
    take contiguous ranges of the table row, in rank order, every page in
    exactly one; the grid is one cluster per (slot, kv head); at head
    widths 64 and 128 alike."""
    npp, pg, g = shape
    for elem, d in ((e, d) for e in (2, 1) for d in tops.DECODE_HEAD_DIMS):
        plan = tops.decode_paged_plan(SERVE_SLOTS, SERVE_KV_HEADS, npp, pg,
                                      g, elem, d)
        c = plan.cluster
        assert c in (1, 2, 4, 8) and c <= npp
        assert plan.grid == SERVE_SLOTS * SERVE_KV_HEADS * c
        pages = _rank_pages(plan, npp)
        assert [j for rank in pages for j in rank] == list(range(npp))
        assert all(rank for rank in pages[:-1])  # only the last may be empty


@pytest.mark.parametrize("shape", PAGED_PLAN_SHAPES)
def test_decode_paged_plan_fits_shared_memory(shape):
    """A round holds at least one page and at most PAGED_ROUND_BYTES of K
    and V (or one page, if a page is larger), a rank of several rounds gets
    two buffers, and a block's shared memory (the buffers and everything
    beside them) fits the H100's 227 KB, at head widths 64, 128 and 80 (a
    bf16 row of 80 buffered 88 wide)."""
    npp, pg, g = shape
    assert tops.decode_row(80, 2) == 88 and tops.decode_row(80, 1) == 80
    for elem, d in ((e, d) for e in (2, 1) for d in tops.DECODE_HEAD_DIMS):
        plan = tops.decode_paged_plan(SERVE_SLOTS, SERVE_KV_HEADS, npp, pg,
                                      g, elem, d)
        row = tops.decode_row(d, elem) * elem
        rnd, page = plan.pages_per_round, 2 * pg * row
        assert 1 <= rnd <= plan.pages_per_rank
        assert rnd * page <= max(tops.PAGED_ROUND_BYTES, page)
        assert plan.buffers == (1 if rnd == plan.pages_per_rank else 2)
        kv = plan.buffers * 2 * (-(-rnd * pg // 16) * 16) * row
        assert kv < plan.smem <= tops.SMEM_MAX == 232448


@pytest.mark.parametrize("elem", [2, 1])
def test_decode_paged_plan_fills_the_card_at_the_serve_shape(elem):
    """At the serve shape (4 slots, 5 kv heads, 64 entries of 16-token
    pages) the split puts a block on every one of the 132 SMs: clusters of
    8, 8 pages a rank, all of them in one round."""
    plan = tops.decode_paged_plan(4, 5, 64, 16, 4, elem, 64)
    assert plan.grid >= 132 and plan.cluster == 8
    assert plan.pages_per_rank == plan.pages_per_round == 8


def _table_pages(pt, pg):
    """K8 / K9's pages: page j of slot ``row`` is table entry e, its keys
    the flat tokens e pg + t of the pools; None where unallocated."""
    def pages(row, j):
        e = int(pt[row, j])
        if e < 0:
            return None
        return e * pg + torch.arange(pg), torch.ones(pg, dtype=torch.bool)
    return pages


def _ring_pages(length, pg=tops.RING_PAGE):
    """K6 / K7's virtual pages of a ring row: key t of page j is the flat
    token row L + j pg + t, present while j pg + t < L."""
    def pages(row, j):
        t = j * pg + torch.arange(pg)
        return row * length + torch.clamp_max(t, length - 1), t < length
    return pages


def _split_model(qf, k, v, pos, pt, qpos, window, cluster, ppr, rnd,
                 ks=None, vs=None, ring=False):
    """The decode kernels' order of work in plain PyTorch (fp32): each
    cluster rank lists the pages of its range of the row that hold a
    visible key, sweeps them in rounds of ``rnd`` with the online softmax
    (m, l, acc), and the ranks' partials are combined in rank order.  K8 /
    K9: pools (P, pg, KH, D), ``pt`` the (S, npp) page table; K6 / K7
    (``ring``): caches (B, L, KH, D) as ``RING_PAGE``-key virtual pages,
    ``pt`` unused.  ``ks`` / ``vs``: the int8 caches' fp16 scales, folded
    as the kernels fold them."""
    s, kh, g, d = qf.shape
    if ring:
        npp = -(-k.shape[1] // tops.RING_PAGE)
        pages = _ring_pages(k.shape[1])
    else:
        npp = pt.shape[1]
        pages = _table_pages(pt, k.shape[1])
    k, v = k.reshape(-1, kh, d), v.reshape(-1, kh, d)
    pos = pos.reshape(-1)
    if ks is not None:
        ks, vs = ks.reshape(-1, kh).float(), vs.reshape(-1, kh).float()
    out = torch.zeros((s, kh, g, d))
    for slot in range(s):
        qp = int(qpos[slot])
        for h in range(kh):
            parts = []
            for r in range(cluster):
                m = torch.full((g,), -1e30)
                l, acc = torch.zeros(g), torch.zeros((g, d))
                listed = []
                for j in range(r * ppr, min(npp, (r + 1) * ppr)):
                    page = pages(slot, j)
                    if page is None:
                        continue
                    tok, present = page
                    kp = pos[tok].long()
                    vis = present & (kp >= 0) & (kp <= qp)
                    if window is not None:
                        vis &= qp - kp < window
                    if bool(vis.any()):
                        listed.append((tok, vis))
                for i in range(0, len(listed), rnd):
                    rows = listed[i:i + rnd]
                    tok = torch.cat([t for t, _ in rows])
                    vis = torch.cat([vv for _, vv in rows])
                    sc = qf[slot, h] @ k[tok, h].T
                    if ks is not None:
                        sc = sc * ks[tok, h]
                    sc = torch.where(vis, sc, -1e30)
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    p = torch.where(vis, torch.exp(sc - m_new[:, None]), 0.0)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=1)
                    if vs is not None:
                        p = p * vs[tok, h]
                    acc = acc * corr[:, None] + p @ v[tok, h].float()
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
            a, total = torch.zeros((g, d)), torch.zeros(g)
            for pm, pl, pa in parts:  # rank order
                f = torch.exp(pm - mx)
                a = a + pa * f[:, None]
                total = total + pl * f
            out[slot, h] = a / torch.clamp_min(total, 1e-30)[:, None]
    return out


def _split_fixture():
    """4 slots of 16-token pages, 16 table entries: slot 0 holds 250 tokens
    with entry 3 unallocated (-1), slot 1 100 tokens (ranks 4 - 7 of 8 hold
    no page), slot 2 is inactive, slot 3 holds 40.  With window 200 slot 0's
    ranks 0 and 1 see no key."""
    rng = np.random.default_rng(5)
    pg, npp, kh, g, d = 16, 16, 2, 4, 64
    lens = (250, 100, 0, 40)
    n_pages = 1 + sum(-(-n // pg) for n in lens)
    pos = np.full((n_pages, pg), -1, np.int32)
    pt = np.full((len(lens), npp), -1, np.int32)
    pages = iter(rng.permutation(np.arange(1, n_pages)))
    for slot, n in enumerate(lens):
        for j in range(-(-n // pg)):
            page = next(pages)
            pt[slot, j] = page
            ln = min(pg, n - j * pg)
            pos[page, :ln] = np.arange(j * pg, j * pg + ln)
    pt[0, 3] = -1
    qpos = np.array([n - 1 if n else -1 for n in lens], np.int32)
    qf = (rng.normal(size=(len(lens), kh, g, d)) / np.sqrt(d)) \
        .astype(np.float32)
    k = rng.normal(size=(n_pages, pg, kh, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, pg, kh, d)).astype(np.float32)
    return qf, k, v, pos, pt, qpos


@pytest.mark.parametrize("rounds", ["plan", "one page a round"])
@pytest.mark.parametrize("kind", ["K8", "K9"])
@pytest.mark.parametrize("window", [None, 200])
def test_decode_paged_split_model_matches_reference(window, kind, rounds):
    """The split as K8 / K9 run it (the plan's ranks, rounds of the plan's
    size or of one page, the ranks combined in rank order) against the
    Pallas kernels in interpret mode and the port's plain versions, within
    1e-5 (fp32, sums in another order); slot 2 (inactive) exactly 0."""
    qf, k, v, pos, pt, qpos = _split_fixture()
    s, kh, g, _ = qf.shape
    plan = tops.decode_paged_plan(s, kh, pt.shape[1], k.shape[1], g,
                                  2 if kind == "K8" else 1, qf.shape[-1])
    assert plan.cluster == 8 and plan.pages_per_rank == 2
    rnd = plan.pages_per_round if rounds == "plan" else 1
    if kind == "K8":
        j = [jnp.asarray(a) for a in (qf, k, v, pos, pt, qpos)]
        ref = decode_kernel.decode_paged(
            j[0], j[1], j[2], j[3], j[4], j[5].reshape(-1, 1), window=window,
            interpret=True)
        plain = tops.decode_paged(*[_t(a) for a in (qf, k, v, pos, pt, qpos)],
                                  window=window)
        model = _split_model(_t(qf), _t(k), _t(v), _t(pos), _t(pt),
                             _t(qpos), window, plan.cluster,
                             plan.pages_per_rank, rnd)
    else:
        kc, ks = (np.asarray(a) for a in jattn.quantize_kv_token(
            jnp.asarray(k * 2)))
        vc, vs = (np.asarray(a) for a in jattn.quantize_kv_token(
            jnp.asarray(v)))
        j = [jnp.asarray(a) for a in (qf, kc, vc, ks, vs, pos, pt, qpos)]
        ref = decode_kernel.decode_paged_q8(
            j[0], j[1], j[2], j[3].astype(jnp.float32).transpose(0, 2, 1),
            j[4].astype(jnp.float32).transpose(0, 2, 1), j[5], j[6],
            j[7].reshape(-1, 1), window=window, interpret=True)
        plain = tops.decode_paged_q8(
            *[_t(a) for a in (qf, kc, vc, ks, vs, pos, pt, qpos)],
            window=window)
        model = _split_model(_t(qf), _t(kc).float(), _t(vc).float(),
                             _t(pos), _t(pt), _t(qpos), window,
                             plan.cluster, plan.pages_per_rank, rnd,
                             ks=_t(ks), vs=_t(vs))
    np.testing.assert_allclose(model.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(model.numpy(), plain.numpy(), atol=ATOL)
    assert np.all(model.numpy()[2] == 0.0)


# ---------------------------------------------------------------------------
# K6 / K7: the ring row as virtual pages, on the same plan and split
# ---------------------------------------------------------------------------

RING_LENGTHS = (1, 15, 16, 17, 37, 100, 509, 825, 2000, 4096)


def _ring_plan(b, kh, length, g, elem, d=64):
    return tops.decode_paged_plan(b, kh, -(-length // tops.RING_PAGE),
                                  tops.RING_PAGE, g, elem, d)


@pytest.mark.parametrize("length", RING_LENGTHS)
def test_decode_ring_plan_covers_every_key_once(length):
    """The ranks' virtual pages cover every key slot of [0, L) exactly
    once, in rank order; no page starts at or past L (only the last may be
    ragged); the cluster is a power of two, at most 8 and at most the
    number of pages; the plan fits a block's shared memory; at head widths
    64 and 128."""
    pg = tops.RING_PAGE
    npp = -(-length // pg)
    for g in (1, 4, 16):
        for elem, d in ((e, d) for e in (2, 1)
                        for d in tops.DECODE_HEAD_DIMS):
            plan = _ring_plan(SERVE_SLOTS, SERVE_KV_HEADS, length, g, elem,
                              d)
            assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= npp
            assert plan.grid == SERVE_SLOTS * SERVE_KV_HEADS * plan.cluster
            pages = _rank_pages(plan, npp)
            assert all(j * pg < length for rank in pages for j in rank)
            keys = [j * pg + t for rank in pages for j in rank
                    for t in range(pg) if j * pg + t < length]
            assert keys == list(range(length))
            assert plan.smem <= tops.SMEM_MAX


@pytest.mark.parametrize("elem", [2, 1])
def test_decode_ring_plan_at_the_generate_shape(elem):
    """At the generate shape (B 4, KH 5, G 4, ring caches of 825) the split
    puts a block on every SM: clusters of 8 (160 blocks), 7 virtual pages
    (112 keys) a rank, all in one round (bf16 K + V: 28 KB)."""
    plan = _ring_plan(4, 5, 825, 4, elem)
    assert plan.grid == 160 and plan.cluster == 8
    assert plan.pages_per_rank == plan.pages_per_round == 7
    assert plan.buffers == 1


def _ring_split_fixture():
    """A ring of ragged L 100 (6 full virtual pages and one of 4 keys) for
    B 4, KH 2, G 4: row 0 holds positions 0 - 99 (full, unwrapped), row 1
    has wrapped (positions 151 - 250, slot p mod 100), row 2 is inactive
    (qpos = -1), row 3 holds positions 0 - 40.  With window 30 rows 0 and
    1 see 30 keys, and the ranks of row 0 that hold slots 0 - 63 see
    none."""
    rng = np.random.default_rng(9)
    b, length, kh, g, d = 4, 100, 2, 4, 64
    qpos = np.array([99, 250, -1, 40], np.int32)
    kpos = np.full((b, length), -1, np.int32)
    for row, qp in enumerate(qpos):
        for p in range(max(0, qp - length + 1), qp + 1):
            kpos[row, p % length] = p
    qf = (rng.normal(size=(b, kh, g, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.normal(size=(b, length, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, length, kh, d)).astype(np.float32)
    return qf, k, v, kpos, qpos


@pytest.mark.parametrize("rounds", ["plan", "one page a round"])
@pytest.mark.parametrize("kind", ["K6", "K7"])
@pytest.mark.parametrize("window", [None, 30])
def test_decode_ring_split_model_matches_reference(window, kind, rounds):
    """K6 / K7's split (the plan's clusters over the ring row's virtual
    pages, rounds of the plan's size or of one page, the ranks combined in
    rank order) against the Pallas kernels in interpret mode and the
    port's plain versions, and those two against each other, within 1e-5
    (fp32, sums in another order); the inactive row exactly 0."""
    qf, k, v, kpos, qpos = _ring_split_fixture()
    b, kh, g, _ = qf.shape
    plan = _ring_plan(b, kh, k.shape[1], g, 2 if kind == "K6" else 1)
    assert plan.cluster == 4 and plan.pages_per_rank == 2
    rnd = plan.pages_per_round if rounds == "plan" else 1
    split = dict(window=window, cluster=plan.cluster,
                 ppr=plan.pages_per_rank, rnd=rnd, ring=True)
    if kind == "K6":
        j = [jnp.asarray(a) for a in (qf, k, v, kpos, qpos)]
        ref = decode_kernel.decode(*j[:4], j[4].reshape(-1, 1),
                                   window=window, block=20, interpret=True)
        plain = tops.decode(*[_t(a) for a in (qf, k, v, kpos, qpos)],
                            window=window)
        model = _split_model(_t(qf), _t(k), _t(v), _t(kpos), None,
                             _t(qpos), **split)
    else:
        kc, ks = (np.asarray(a) for a in jattn.quantize_kv_token(
            jnp.asarray(k * 2)))
        vc, vs = (np.asarray(a) for a in jattn.quantize_kv_token(
            jnp.asarray(v)))
        j = [jnp.asarray(a) for a in (qf, kc, vc, ks, vs, kpos, qpos)]
        ref = decode_kernel.decode_q8(
            j[0], j[1], j[2], j[3].astype(jnp.float32).transpose(0, 2, 1),
            j[4].astype(jnp.float32).transpose(0, 2, 1), j[5],
            j[6].reshape(-1, 1), window=window, block=20, interpret=True)
        plain = tops.decode_q8(
            *[_t(a) for a in (qf, kc, vc, ks, vs, kpos, qpos)],
            window=window)
        model = _split_model(_t(qf), _t(kc).float(), _t(vc).float(),
                             _t(kpos), None, _t(qpos), ks=_t(ks), vs=_t(vs),
                             **split)
    np.testing.assert_allclose(model.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(model.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=ATOL)
    assert np.all(model.numpy()[2] == 0.0)
    assert np.all(plain.numpy()[2] == 0.0)
