"""The port's weight-only serving quantization (``repro_torch.wq``) against
the JAX package's ``repro.wq``, on the CPU: the per-column packers, RTN and
GPTQ bit for bit, the plain K12 against the JAX kernel in interpret mode
and its jnp reference, the calibration Hessians, GPTQ-vs-RTN held out,
packed checkpoints across the packages, and the quantized ServeEngine
token-exact against JAX's."""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import wq as jwq  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.utils.tree import weight_sites as j_weight_sites  # noqa: E402
from repro.wq.packed import pack_weight_codes as j_pack  # noqa: E402
from repro_torch import wq  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wq_ops  # noqa: E402
from repro_torch.kernels.wq_ops import wq_matmul_kernel  # noqa: E402
from repro_torch.models import stack  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.utils.tree import tree_bytes, weight_sites  # noqa: E402
from repro_torch.wq.packed import (pack_weight_codes,  # noqa: E402
                                   unpack_weight_codes)

CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()
# the plain K12 against the JAX kernel and the jnp reference in fp32:
# the same dequantized weights, summed in another order
ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jtf.init_params(jax.random.PRNGKey(0), CFG)
    return jp, from_jax_params(jp, "cpu")


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _assert_same_store(jstore, tstore):
    """A reference PackedLinear and the port's: equal layout, children
    bit for bit."""
    assert (tstore.bits, tstore.group, tstore.d_in, tstore.d_out) == \
        (jstore.bits, jstore.group, jstore.d_in, jstore.d_out)
    for name in ("codes", "scales", "mins", "perm"):
        a, b = getattr(jstore, name), getattr(tstore, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, name
            np.testing.assert_array_equal(b.numpy().view(np.uint8),
                                          a.view(np.uint8), err_msg=name)


# ---------------------------------------------------------------------------
# the structural site rule, the packers
# ---------------------------------------------------------------------------

def test_weight_sites_match_reference(params):
    jp, tp = params
    for side in ("client", "server"):
        ref = [p for p, _ in j_weight_sites(jp[side])]
        assert [p for p, _ in weight_sites(tp[side])] == ref and ref


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("d_in", [64, 100])
def test_pack_weight_codes_byte_identical(bits, d_in):
    codes = np.random.default_rng(bits * d_in).integers(
        0, 1 << bits, (d_in, 5)).astype(np.uint8)
    ref = np.asarray(j_pack(jnp.asarray(codes), bits))
    words = pack_weight_codes(torch.from_numpy(codes), bits)
    assert words.dtype == torch.uint8
    np.testing.assert_array_equal(words.numpy(), ref)
    # each column is core.packing's exact stream
    np.testing.assert_array_equal(
        words[:, 2].numpy(),
        np.asarray(jpacking.pack_bits(jnp.asarray(codes[:, 2]), bits)))
    for back in (unpack_weight_codes(words, bits, d_in),
                 tref.wq_unpack_ref(words, bits, d_in)):
        np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        tref.wq_unpack_ref(words, bits, d_in).numpy(),
        np.asarray(jref.wq_unpack_ref(jnp.asarray(ref), bits, d_in)))


# ---------------------------------------------------------------------------
# RTN and GPTQ, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,group,d_in,d_out",
                         [(4, 128, 256, 384), (3, 32, 100, 130),
                          (2, 32, 64, 96)])
def test_rtn_bit_identical(bits, group, d_in, d_out):
    w = _normal(0, (d_in, d_out), 0.3)
    w[:group, 0] = 0.7  # a constant group: fp16 scale 0, code 0
    cfg = dict(bits=bits, group=group)
    jstore = jwq.rtn_quantize(jnp.asarray(w), jwq.WqConfig(**cfg))
    tstore = wq.rtn_quantize(torch.from_numpy(w), wq.WqConfig(**cfg))
    _assert_same_store(jstore, tstore)
    assert float(tstore.scales[0, 0]) == 0.0
    np.testing.assert_array_equal(tstore.dequantize()[:group, 0].numpy(),
                                  np.float32(np.float16(0.7)))


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("bits,d_in", [(4, 128), (3, 100)])
def test_gptq_bit_identical(act_order, bits, d_in):
    d_out = 96
    w = _normal(0, (d_in, d_out), 0.3)
    x = _normal(1, (256, d_in)) @ _normal(2, (d_in, d_in), 0.15)
    h = x.T @ x
    h[3, :] = h[:, 3] = 0.0  # a dead channel
    cfg = dict(bits=bits, group=32, act_order=act_order)
    jstore = jwq.gptq_quantize(jnp.asarray(w), h, jwq.WqConfig(**cfg))
    tstore = wq.gptq_quantize(torch.from_numpy(w), h, wq.WqConfig(**cfg))
    _assert_same_store(jstore, tstore)
    assert (tstore.perm is not None) == act_order


# ---------------------------------------------------------------------------
# the plain K12 against the JAX kernel (interpret mode) and jnp reference
# ---------------------------------------------------------------------------

def _matmul_case(store, x):
    """(port y, JAX Pallas y, JAX jnp y, port dense y) of ``x @ store``."""
    tstore = from_jax_params({"w": store}, "cpu")["w"]
    y = wq.wq_matmul(torch.from_numpy(x), tstore)
    y_pl = jwq.wq_matmul(jnp.asarray(x), store, impl="pallas")
    y_jnp = jwq.wq_matmul(jnp.asarray(x), store, impl="jnp")
    y_dense = torch.from_numpy(x) @ tstore.dequantize()
    return y.numpy(), np.asarray(y_pl), np.asarray(y_jnp), y_dense.numpy()


@pytest.mark.parametrize("bits,group,d_in,d_out",
                         [(4, 128, 256, 384), (3, 32, 256, 130),
                          (4, 32, 100, 128), (2, 32, 64, 96)])
def test_plain_matmul_matches_reference(bits, group, d_in, d_out):
    store = jwq.rtn_quantize(jnp.asarray(_normal(0, (d_in, d_out), 0.3)),
                             jwq.WqConfig(bits=bits, group=group))
    y, y_pl, y_jnp, y_dense = _matmul_case(store, _normal(1, (9, d_in)))
    assert y.dtype == np.float32 and y.shape == (9, d_out)
    for other in (y_pl, y_jnp, y_dense):
        np.testing.assert_allclose(y, other, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bits", [4, 3])
def test_plain_matmul_act_order(bits):
    d_in, d_out = 128, 96
    x = _normal(1, (256, d_in))
    store = jwq.gptq_quantize(
        jnp.asarray(_normal(0, (d_in, d_out), 0.3)), x.T @ x,
        jwq.WqConfig(bits=bits, group=32, act_order=True))
    assert store.perm is not None
    y, y_pl, y_jnp, y_dense = _matmul_case(store, _normal(2, (5, d_in)))
    for other in (y_pl, y_jnp, y_dense):  # dense: original channel order
        np.testing.assert_allclose(y, other, atol=ATOL, rtol=RTOL)


def test_plain_matmul_rounds_weights_to_the_activation_dtype():
    store = wq.rtn_quantize(torch.from_numpy(_normal(0, (64, 48), 0.3)),
                            wq.WqConfig(bits=4, group=32))
    x = torch.from_numpy(_normal(1, (3, 64))).bfloat16()
    y = x @ store.to(x.dtype)
    assert y.dtype == torch.bfloat16
    dense = x.float() @ store.dequantize().bfloat16().float()
    torch.testing.assert_close(y, dense.bfloat16(), atol=0, rtol=0)


def test_matmul_rejects_stacked_and_mismatched():
    cfg = wq.WqConfig(bits=4, group=32)
    w = torch.from_numpy(_normal(0, (2, 64, 32)))
    stacked = wq.quantize_linear(w, cfg)
    with pytest.raises(ValueError, match="stacked"):
        wq.wq_matmul(torch.zeros((3, 64)), stacked)
    flat = wq.quantize_linear(w[0], cfg)
    with pytest.raises(ValueError, match="feature dim"):
        wq.wq_matmul(torch.zeros((3, 65)), flat)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The wrapper launches or raises: CPU operands, and a perm of the wrong
    dtype, length or device, are refused before any launch."""
    store = wq.rtn_quantize(torch.from_numpy(_normal(0, (64, 32))),
                            wq.WqConfig(bits=4, group=32))
    args = (torch.zeros((3, 64)), store.codes, store.scales, store.mins)
    kw = dict(bits=4, group=32, d_in=64)
    with pytest.raises(ValueError, match="CUDA"):
        wq_matmul_kernel(*args, **kw)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA"):
        wq_matmul_kernel(*args, perm=perm.int(), **kw)
    with pytest.raises(ValueError, match="perm"):
        wq_matmul_kernel(*args, perm=perm, **kw)  # int64
    with pytest.raises(ValueError, match="perm"):
        wq_matmul_kernel(*args, perm=perm[:63].int(), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        wq_matmul_kernel(*args, perm=perm.int().to("meta"), **kw)


# the serve path's K12 sites (d_in, d_out) and ragged shapes
K12_SHAPES = [(1280, 1280), (1280, 320), (1280, 3456), (3456, 1280),
              (100, 130), (1216, 336), (8, 16), (10000, 64)]


@pytest.mark.parametrize("m", [1, 4, 16, 17, 1024, 4096])
@pytest.mark.parametrize("d_in,d_out", K12_SHAPES)
def test_k12_variant_by_m(m, d_in, d_out):
    """The split-K GEMV up to 16 rows; above that the TMA + wgmma kernel
    wherever the tensor maps can describe the operands (d_in a multiple
    of 64, d_out of 16), the GEMV elsewhere."""
    want = "wgmma" if m > 16 and d_in % 64 == 0 and d_out % 16 == 0 \
        else "gemv"
    assert wq_ops.variant(m, d_in, d_out) == want


@pytest.mark.parametrize("m", [1, 4, 16, 40])
@pytest.mark.parametrize("d_in,d_out", K12_SHAPES)
def test_gemv_plan_covers_k_exactly(m, d_in, d_out):
    """The GEMV's grid: every column and row chunk has a cluster; the
    blocks of a cluster and the warps of a block take k16 steps that
    cover ceil(d_in / 16) exactly once, every block at least one; the
    launcher's own conditions hold."""
    tiles, chunks, splits, sps, spw = wq_ops.gemv_plan(m, d_in, d_out)
    steps = -(-d_in // 16)
    assert tiles * wq_ops.GEMV_COLS >= d_out > (tiles - 1) * wq_ops.GEMV_COLS
    assert chunks * wq_ops.GEMV_ROWS >= m > (chunks - 1) * wq_ops.GEMV_ROWS
    assert 1 <= splits <= wq_ops.GEMV_MAX_SPLITS
    assert splits * sps >= steps and wq_ops.GEMV_WARPS * spw >= sps
    seen = []
    for ks in range(splits):
        assert ks * sps < steps  # no empty block
        for w in range(wq_ops.GEMV_WARPS):  # the kernel's loop bounds
            seen += [ks * sps + st for st in range(w * spw,
                                                   min((w + 1) * spw, sps))]
    assert sorted(s for s in seen if s < steps) == list(range(steps))
    assert len(seen) == len(set(seen))


@pytest.mark.parametrize("d_in,d_out", K12_SHAPES[:4])
def test_gemv_shared_memory_fits(d_in, d_out):
    """A GEMV block's shared memory (its K slice of the store, of x's 16
    rows, and the warps' sums) fits the 227 KB at every serve site."""
    for bits, group in ((4, 128), (3, 128), (2, 64), (4, 8)):
        need = wq_ops.gemv_smem_bytes(16, d_in, d_out, bits, group)
        _, _, _, sps, _ = wq_ops.gemv_plan(16, d_in, d_out)
        assert sps * 2 * bits * wq_ops.GEMV_COLS < need \
            <= wq_ops.GEMV_SMEM_MAX


@pytest.mark.parametrize("m,d_out,want", [
    (4096, 3456, 256), (4096, 1280, 256), (4096, 320, 128),
    (1024, 3456, 256), (1024, 1280, 128), (1024, 320, 64), (17, 3456, 64)])
def test_wgmma_tokens_fill_the_card(m, d_out, want):
    """The largest block of x's rows that still keeps the 132 SMs busy:
    256 rows (one block per SM) for three quarters of them, 128 (two per
    SM) for half, else 64."""
    assert wq_ops.wgmma_tokens(m, d_out) == want


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wq_matmul_returns_x_dtype(dtype, act_order):
    """``wq_matmul`` returns x's dtype: the plain K12's fp32 sum on the
    act-order gather of x, rounded once to x's dtype."""
    d_in, d_out = 128, 96
    xs = _normal(1, (256, d_in))
    store = wq.gptq_quantize(torch.from_numpy(_normal(0, (d_in, d_out), 0.3)),
                             xs.T @ xs,
                             wq.WqConfig(bits=4, group=32,
                                         act_order=act_order))
    assert (store.perm is not None) == act_order
    x = torch.from_numpy(_normal(2, (2, 5, d_in))).to(dtype)
    y = wq.wq_matmul(x, store)
    x2 = x.reshape(-1, d_in)
    if act_order:
        x2 = torch.index_select(x2, -1, store.perm)
    plain = tref.wq_matmul_ref(x2, store.codes, store.scales, store.mins,
                               bits=4, group=32, d_in=d_in)
    assert y.dtype == dtype and y.shape == (2, 5, d_out)
    assert torch.equal(y, plain.to(dtype).reshape(2, 5, d_out))


# ---------------------------------------------------------------------------
# the store as a tree leaf: stack helpers, device moves, bytes
# ---------------------------------------------------------------------------

def test_packed_linear_as_a_stacked_leaf():
    cfg = wq.WqConfig(bits=3, group=32, act_order=True)
    w = torch.from_numpy(_normal(0, (3, 64, 40)))
    x = _normal(1, (128, 64))
    h = np.stack([x.T @ x] * 3)
    store = wq.quantize_linear(w, cfg, h)
    assert store.shape == (3, 64, 40) and store.ndim == 3
    assert store.batch_shape == (3,)
    tree = {"ffn": {"w_up": store, "ln": torch.ones(3, 64)}}
    assert stack.stack_len(tree) == 3
    layers = stack.tree_unbind(tree)
    assert len(layers) == 3
    for i, layer in enumerate(layers):
        one = layer["ffn"]["w_up"]
        assert one.shape == (64, 40) and one.perm.shape == (64,)
        torch.testing.assert_close(one.dequantize(), store.dequantize()[i])
        assert stack.tree_index(tree, i)["ffn"]["w_up"].shape == (64, 40)
    back = stack.tree_stack(layers)["ffn"]["w_up"]
    for name in ("codes", "scales", "mins", "perm"):
        assert torch.equal(getattr(back, name), getattr(store, name))
    # .to: the identity for a dtype, a move for a device; fp16 kept
    assert store.to(torch.bfloat16) is store
    moved = store.to(torch.device("cpu"))
    assert moved.scales.dtype == torch.float16 and moved.codes.dtype == \
        torch.uint8 and moved.perm.dtype == torch.int32
    assert tree_bytes(tree) == store.packed_bytes() + 3 * 64 * 4
    assert store.packed_bytes() == 3 * (24 * 40 + 2 * 2 * 2 * 40 + 64 * 4)
    assert wq.packed_tree_bytes(tree) == tree_bytes(tree)
    with pytest.raises(TypeError):
        store[0] @ torch.zeros((40, 2))


# ---------------------------------------------------------------------------
# calibration and GPTQ's gain over RTN
# ---------------------------------------------------------------------------

def test_collect_hessians_matches_reference(params):
    jp, tp = params
    calib = next(jmake_pipeline(CFG, 2, 24))
    ref = jwq.collect_hessians(jp, CFG, calib)
    out = wq.collect_hessians(tp, TCFG, calib)
    assert sorted(out) == sorted(ref) and len(out) == 14
    for path, h in out.items():
        assert h.dtype == np.float32 and h.shape == ref[path].shape
        # fp32 sums of the same products in another order, after two
        # layers and the 2-bit cut: a relative Frobenius error
        rel = np.linalg.norm(h - ref[path]) / np.linalg.norm(ref[path])
        assert rel < 1e-4, (path, rel)


@pytest.mark.parametrize("bits", [4, 3])
def test_gptq_beats_rtn_on_heldout_reconstruction(bits):
    # correlated inputs (trained nets' anisotropic feature spectra) are
    # where Hessian compensation pays; the held-out split guards against
    # calibration overfit
    d_in, d_out = 128, 96
    a = torch.from_numpy(_normal(0, (d_in, d_in), 0.15))
    xc = torch.from_numpy(_normal(1, (2048, d_in))) @ a
    xh = torch.from_numpy(_normal(2, (512, d_in))) @ a
    w = torch.from_numpy(_normal(3, (d_in, d_out), 0.3))
    cfg = wq.WqConfig(bits=bits, group=32)

    def heldout_err(p):
        return float(torch.linalg.norm(xh @ (p.dequantize() - w)))

    e_rtn = heldout_err(wq.rtn_quantize(w, cfg))
    e_gptq = heldout_err(wq.gptq_quantize(w, (xc.T @ xc).numpy(), cfg))
    assert e_gptq < 0.85 * e_rtn, (e_gptq, e_rtn)


def _anisotropic(tp):
    """A power-law feature spectrum on the embedding and the connector
    (random init is white, where GPTQ degenerates to RTN)."""
    d = TCFG.d_model
    col = (1.0 / torch.sqrt(1.0 + torch.arange(d, dtype=torch.float32))) * 3
    out = dict(tp)
    for k in ("embed", "connector"):
        out[k] = {n: v * col if v.shape[-1] == d else v
                  for n, v in tp[k].items()}
    return out


def test_gptq_model_level_heldout_kl_beats_rtn(params):
    tp = _anisotropic(params[1])
    calib = next(make_pipeline(TCFG, 16, 64))
    held = {k: torch.as_tensor(v)
            for k, v in next(make_pipeline(TCFG, 4, 48, seed=123)).items()}
    hessians = wq.collect_hessians(tp, TCFG, calib)
    wcfg = wq.parse_weight_quant("int3", group=32)
    gq, _ = wq.quantize_params(tp, wcfg, hessians=hessians)
    rt, _ = wq.quantize_params(tp, wcfg)
    with torch.inference_mode():
        pd = torch.log_softmax(ttf.forward(tp, TCFG, held)[0], dim=-1)

        def kl(qp):
            pq = torch.log_softmax(ttf.forward(qp, TCFG, held)[0], dim=-1)
            return float((pd.exp() * (pd - pq)).sum(-1).mean())

        k_gptq, k_rtn = kl(gq), kl(rt)
    assert k_gptq < k_rtn, (k_gptq, k_rtn)


# ---------------------------------------------------------------------------
# packed checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gptq_tree(params):
    """The reference's int4 act-order GPTQ tree of the reduced model, and
    the same tree carried into the port."""
    jp, _ = params
    hs = jwq.collect_hessians(jp, CFG, next(jmake_pipeline(CFG, 2, 16)))
    qp, _ = jwq.quantize_params(
        jp, jwq.parse_weight_quant("int4", group=128, act_order=True),
        hessians=hs)
    return qp, from_jax_params(qp, "cpu")


def _assert_same_trees(jtree, ttree):
    is_store = lambda x: isinstance(x, jwq.PackedLinear)  # noqa: E731
    flat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=is_store)[0]
    assert sum(is_store(leaf) for _, leaf in flat) == 14  # 7 per layer
    for path, leaf in flat:
        node = ttree
        for key in path:
            node = node[key.key]
        if is_store(leaf):
            _assert_same_store(leaf, node)
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_packed_checkpoint_crosses_packages(gptq_tree, tmp_path, writer):
    qp, tq = gptq_tree
    path = str(tmp_path / "wq.npz")
    if writer == "jax":
        jckpt.save(path, qp)
        back = ckpt.restore(path, tq)
        _assert_same_trees(qp, back)
        site = back["server"]["seg0"]["attn"]["wq"]
        assert isinstance(site, wq.PackedLinear) and site.perm is not None
    else:
        ckpt.save(path, tq)
        with np.load(path) as data:
            assert "server/seg0/attn/wq/perm" in data.files
            assert "server/seg0/attn/wq/bits" not in data.files
        back = jckpt.restore(path, jax.tree_util.tree_map(jnp.zeros_like,
                                                          qp))
        _assert_same_trees(back, tq)


def test_packed_checkpoint_without_perm(params, tmp_path):
    tp = params[1]
    qp, _ = wq.quantize_params(tp, wq.parse_weight_quant("int3", group=32))
    path = str(tmp_path / "rtn.npz")
    ckpt.save(path, qp)
    with np.load(path) as data:
        assert "server/seg0/ffn/w_up/codes" in data.files
        assert not any(k.endswith("/perm") for k in data.files)
    back = ckpt.restore(path, qp)
    site = back["server"]["seg0"]["ffn"]["w_up"]
    assert site.perm is None
    assert torch.equal(site.codes, qp["server"]["seg0"]["ffn"]["w_up"].codes)


# ---------------------------------------------------------------------------
# the quantized ServeEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(3)
    return [(rng.integers(1, CFG.vocab_size, int(rng.integers(3, 14)))
             .tolist(), int(rng.integers(2, 5)),
             rng.normal(size=(CFG.n_image_tokens, CFG.d_vision))
             .astype(np.float32)) for _ in range(4)]


class _Picks:
    """Records the logits each ``_pick`` sees."""

    def _pick(self, last_logits):
        self.picked.append(np.array(last_logits, np.float32))
        return super()._pick(last_logits)


class _JaxTap(_Picks, JaxServeEngine):
    picked: list


class _TorchTap(_Picks, ServeEngine):
    picked: list


def _serve(engine_cls, params, cfg, reqs, **kw):
    n_pages = 1 + sum(-(-(cfg.n_image_tokens + len(t) + m) // 8)
                      for t, m, _ in reqs)
    eng = engine_cls(params, cfg, n_slots=len(reqs), page_size=8,
                     n_pages=n_pages, **kw)
    eng.picked = []
    rids = [eng.submit(t, max_new=m, image_embeds=img) for t, m, img in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


def test_engine_rtn_token_exact_vs_reference(params, requests):
    jp, tp = params
    ref, jeng = _serve(_JaxTap, jp, CFG, requests, weight_quant="int4")
    out, teng = _serve(_TorchTap, tp, TCFG, requests, weight_quant="int4",
                       device="cpu")
    assert out == ref
    for key in ("weight_bytes_dense", "weight_bytes_packed"):
        assert teng.stats[key] == jeng.stats[key], key
    # fp32 reduced model: int4 codes + fp16 (scale, min) per 128 rows
    assert teng.stats["weight_bytes_packed"] * 8 == \
        teng.stats["weight_bytes_dense"] * (0.5 + 4 / 128) * 2
    for j, t in zip(jeng.picked, teng.picked):
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)


def test_engine_bridged_gptq_params_token_exact(params, requests):
    jp, _ = params
    calib = next(jmake_pipeline(CFG, 4, 32))
    ref, jeng = _serve(JaxServeEngine, jp, CFG, requests,
                       weight_quant="int4", wq_act_order=True,
                       wq_calib=calib)
    out, teng = _serve(ServeEngine, from_jax_params(jeng.params, "cpu"),
                       TCFG, requests, device="cpu")
    assert out == ref


def test_engine_gptq_kl_bounded(params):
    tp = params[1]
    b, p, n_new = 8, 16, 2
    calib = next(make_pipeline(TCFG, 8, 32))
    # requests drawn from the calibration distribution (in-domain prompts)
    req = next(make_pipeline(TCFG, b, p, seed=9))
    reqs = [(list(req["tokens"][i]), n_new,
             np.asarray(req["image_embeds"][i], np.float32))
            for i in range(b)]
    _, dense = _serve(_TorchTap, tp, TCFG, reqs, device="cpu")
    _, quant = _serve(_TorchTap, tp, TCFG, reqs, weight_quant="int4",
                      wq_calib=calib, device="cpu")
    assert quant.stats["weight_bytes_packed"] * 3.7 <= \
        quant.stats["weight_bytes_dense"]
    assert quant.stats["wq_calib_seconds"] > 0.0
    # both engines admit all b requests in one prefill batch: compare the
    # first picks' token distributions
    ld, lq = dense.picked[0], quant.picked[0]
    assert ld.shape == lq.shape == (b, TCFG.vocab_size)
    pd = torch.log_softmax(torch.from_numpy(ld), -1)
    pq = torch.log_softmax(torch.from_numpy(lq), -1)
    kl = float((pd.exp() * (pd - pq)).sum(-1).mean())
    assert 0.0 <= kl < 0.3, kl


# ---------------------------------------------------------------------------
# config parsing / validation
# ---------------------------------------------------------------------------

def test_parse_weight_quant_and_validation():
    c = wq.parse_weight_quant("int3", group=32, act_order=True)
    assert dataclasses.astuple(c) == (3, 32, True)
    with pytest.raises(ValueError):
        wq.parse_weight_quant("int9")
    with pytest.raises(ValueError):
        wq.WqConfig(bits=4, group=12)  # not a multiple of 8
