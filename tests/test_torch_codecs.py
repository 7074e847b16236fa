"""The port's codecs against the JAX reference, on the CPU: the exact
bitstream packers, the NF-b codebook, the NF kernels' plain versions (K10 /
K11) against the JAX kernels in interpret mode, the plain and kernel
codecs of NF-b, FSQ, RD-FSQ, Top-K and identity, and grouped payloads."""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core.payload import GroupedPayload as JGrouped  # noqa: E402
from repro.core.payload import bits_per_scalar as j_bits_per_scalar  # noqa
from repro.core.quantizers.nf import nf_codebook as j_nf_codebook  # noqa
from repro.core.quantizers.topk import budget as j_budget  # noqa: E402
from repro.kernels import nf_kernel as jnf_kernel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.core import quantizers as tq  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core.payload import GroupedPayload, bits_per_scalar  # noqa
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.core.quantizers import kernel_codecs  # noqa: E402
from repro_torch.core.quantizers.nf import codebook_tensor  # noqa: E402
from repro_torch.core.quantizers.nf import nf_codebook  # noqa: E402
from repro_torch.core.quantizers.topk import budget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

JQ = jq.QuantConfig


def _x(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _jcfg(cfg: QuantConfig):
    """The reference's QuantConfig with the same fields."""
    return JQ(**dataclasses.asdict(cfg))


def _arrays(payload):
    return [np.asarray(a) for a in payload.arrays()]


def _ulp(values) -> float:
    """One float32 ulp at the scale of ``values``."""
    return float(np.spacing(np.abs(np.asarray(values, np.float32)).max()))


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("n", [1, 7, 64, 257])
def test_pack_bits_byte_identical(bits, n):
    codes = np.random.default_rng(bits * 131 + n).integers(
        0, 2 ** bits, size=(n,)).astype(np.uint8)
    jw = np.asarray(jpacking.pack_bits(jnp.asarray(codes), bits))
    tw = tpacking.pack_bits(torch.as_tensor(codes), bits)
    assert tw.dtype == torch.uint8
    assert tw.shape == (tpacking.packed_size(n, bits),)
    np.testing.assert_array_equal(tw.numpy(), jw)
    back = tpacking.unpack_bits(tw, bits, n)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpacking.unpack_bits(jnp.asarray(jw),
                                                      bits, n)))


def test_unpack_bits_length_checks():
    words = tpacking.pack_bits(torch.arange(9, dtype=torch.uint8) % 8, 3)
    with pytest.raises(ValueError, match="packed_size"):
        tpacking.unpack_bits(words[:-1], 3, 9)  # a missing tail
    with pytest.raises(ValueError, match="disagree"):
        tpacking.unpack_bits(torch.cat([words, words]), 3, 9)
    with pytest.raises(ValueError):
        tpacking.pack_bits(words, 9)


@pytest.mark.parametrize("bits,slot", [(3, 4), (5, 8), (6, 8), (7, 8)])
def test_odd_widths_pack_exactly(bits, slot):
    assert tpacking.storage_bits(bits) == slot
    n = 123
    assert tpacking.packed_size(n, bits) == -(-(n * bits) // 8) \
        < -(-n // (8 // slot))


# ---------------------------------------------------------------------------
# NF-b codebook and the plain versions of K10 / K11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 9))
def test_nf_codebook_value_identical(bits):
    book = nf_codebook(bits)
    assert book == j_nf_codebook(bits)
    assert len(book) == 2 ** bits and 0.0 in book and max(book) == 1.0
    assert all(a < b for a, b in zip(book, book[1:]))


def _blocks(x, block=64):
    flat = x.reshape(-1)
    return np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(4, 700), (3, 257)])
def test_nf_quantize_plain_matches_reference_kernel(bits, shape):
    """K10's plain version: codes, words, m and rng equal to the JAX
    kernel in interpret mode and to ``nf_codes_ref``.  No boundary tie
    occurs on these inputs: a tie needs ``norm`` exactly halfway between
    two codebook entries in float32."""
    x = _x(bits, shape)
    x.reshape(-1)[64:128] = 0.5  # a block of range 0
    blocks = _blocks(x)
    nb = blocks.shape[0]
    book = np.asarray(nf_codebook(bits), np.float32)
    tbook = codebook_tensor(bits, torch.device("cpu"))
    codes, m, rng = tref.nf_codes_ref(torch.as_tensor(blocks), tbook)
    jcodes, jm, jrng = jref.nf_codes_ref(jnp.asarray(blocks),
                                         jnp.asarray(book))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(rng.numpy(), np.asarray(jrng))
    assert (codes.numpy()[1] == 0).all()  # range 0 maps to entry 0 (-1)

    pad = (-nb) % jnf_kernel.BLOCKS_PER_TILE
    jw, jm16, jr16 = jnf_kernel.quantize_pallas(
        jnp.asarray(np.pad(blocks, ((0, pad), (0, 0)))), jnp.asarray(book),
        bits, interpret=True)
    tw, tm16, tr16 = tops.nf_quantize_plain(torch.as_tensor(x.reshape(-1)),
                                            tbook, bits, 64)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw)[:nb])
    np.testing.assert_array_equal(tm16.numpy(), np.asarray(jm16)[:nb])
    np.testing.assert_array_equal(tr16.numpy(), np.asarray(jr16)[:nb])


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("double_quant", [False, True])
def test_nf_wrappers_match_reference(bits, double_quant):
    """``nf_quantize`` gives the reference wrapper's words, scales and
    aux; ``nf_dequantize`` is exact against the formula evaluated op by op
    in IEEE float32 (numpy) and within one float32 ulp, at the scale of the
    values, of the reference's, whose CPU lowering is not correctly
    rounded (as for RD-FSQ, ROADMAP queue F)."""
    x = _x(10 + bits, (4, 700))
    n = x.size
    jw, js, jaux = jops.nf_quantize(jnp.asarray(x), bits, block=64,
                                    double_quant=double_quant)
    tw, ts, taux = tops.nf_quantize(torch.as_tensor(x), bits, block=64,
                                    double_quant=double_quant)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    for out_dtype in (torch.float32, torch.bfloat16):
        ty = tops.nf_dequantize(tw, ts, taux, bits, n, block=64,
                                double_quant=double_quant,
                                out_dtype=out_dtype)
        assert ty.shape == (n,) and ty.dtype == out_dtype
        # IEEE float32, op by op, from the payload
        book = np.asarray(nf_codebook(bits), np.float32)
        per = 8 // tpacking.storage_bits(bits)
        sb = 8 // per
        codes = ((tw.numpy()[..., None] >> (np.arange(per, dtype=np.uint8)
                                            * sb)) & (2 ** sb - 1))
        codes = codes.reshape(tw.shape[0], 64)
        m = taux["block_min"].numpy().astype(np.float32)
        if double_quant:
            nb = tw.shape[0]
            c = np.pad(ts.numpy(), ((0, (-nb) % 256), (0, 0))).reshape(-1,
                                                                       256)
            g = taux["dq_scale"].numpy().astype(np.float32)
            r = (c.astype(np.float32) / np.float32(255.0) * g[:, None]
                 ).reshape(-1, 1)[:nb].astype(np.float16)
        else:
            r = ts.numpy()
        r = r.astype(np.float32)
        ieee = ((book[codes] + np.float32(1)) / np.float32(2) * r + m
                ).reshape(-1)[:n]
        np.testing.assert_array_equal(
            ty.float().numpy(),
            torch.as_tensor(ieee).to(out_dtype).float().numpy())
    jy = np.asarray(jops.nf_dequantize(jw, js, jaux, bits, n, block=64,
                                       double_quant=double_quant))
    np.testing.assert_allclose(jy, ieee, rtol=0, atol=_ulp(ieee))


def test_nf_kernel_launchers_refuse_what_they_cannot_run():
    """K10 / K11's launch wrappers take CUDA operands only (a CPU tensor
    reaches the plain version through ``nf_quantize`` / ``nf_dequantize``,
    never through a failed launch), and whole words per block."""
    book = codebook_tensor(4, torch.device("cpu"))
    flat = torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA"):
        tops.nf_quantize_kernel(flat, book, 4, 64)
    words, m, rng = tops.nf_quantize_plain(flat, book, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tops.nf_dequantize_kernel(words, m, rng, book, 4, 64, 128,
                                  torch.float32)
    with pytest.raises(ValueError, match="whole"):
        tops.nf_quantize_kernel(flat, book, 4, 63)
    with pytest.raises(ValueError, match="pack"):
        tops.nf_quantize_kernel(flat, book, 3, 64)


def test_nf_dequantize_kernel_rounds_the_range_to_fp16():
    """The kernel wrapper's ranges are fp16, the flat-stream decode's
    fp32: both are the reference's behaviours, held to the reference's
    tolerance against each other."""
    x = torch.as_tensor(_x(3, (4, 700)))
    cfg = QuantConfig(method="nf", bits=4)
    k = tq.decode(cfg, tq.encode(cfg, x))
    p = tq.decode(cfg, tq.encode(cfg, x, impl="plain"))
    rt, _ = tq.roundtrip(cfg, x)
    np.testing.assert_allclose(p.numpy(), rt.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(k.numpy(), rt.numpy(), atol=0.1, rtol=5e-2)


# ---------------------------------------------------------------------------
# codecs against the reference's, kernel layout and flat stream
# ---------------------------------------------------------------------------

_CODEC_CASES = [("nf", b) for b in (1, 2, 3, 4, 8)] \
    + [("fsq", b) for b in (1, 2, 3, 5, 8)] \
    + [("rdfsq", b) for b in (1, 3, 5, 6, 7)]


@pytest.mark.parametrize("method,bits", _CODEC_CASES)
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_codec_matches_reference(method, bits, impl):
    """Same payload arrays and wire bytes as the reference's codec of the
    same layout (kernel: the Pallas codec in interpret mode; plain: the
    jnp one), decodes within 1e-6, roundtrip within 1e-6."""
    cfg = QuantConfig(method=method, bits=bits)
    x = _x(bits, (3, 5, 64))
    jimpl = "pallas" if impl == "kernel" else "jnp"
    jp = jq.encode(_jcfg(cfg), jnp.asarray(x), impl=jimpl)
    tp = tq.encode(cfg, torch.as_tensor(x), impl=impl)
    has_kernel = (method == "nf" and kernel_codecs.nf_has_kernel(cfg)) or (
        method == "rdfsq" and kernel_codecs.rdfsq_has_kernel(cfg, x.ndim))
    assert tp.meta["impl"] == ("kernel" if impl == "kernel" and has_kernel
                               else "plain")
    assert tp.wire_bytes() == jp.wire_bytes()
    for a, b in zip(_arrays(tp), _arrays(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tq.decode(cfg, tp).numpy(),
                               np.asarray(jq.decode(_jcfg(cfg), jp)),
                               rtol=0, atol=1e-6)
    ty, tc = tq.roundtrip(cfg, torch.as_tensor(x))
    jy, jc = jq.roundtrip(_jcfg(cfg), jnp.asarray(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(tc), float(jc), atol=1e-6)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rdfsq_tensor_stats_matches_reference(impl):
    cfg = QuantConfig(method="rdfsq", bits=2, stats_axis="tensor")
    x = _x(4, (3, 5, 64))
    tp = tq.encode(cfg, torch.as_tensor(x), impl=impl)
    jp = jq.encode(_jcfg(cfg), jnp.asarray(x), impl="jnp")
    assert tp.meta["impl"] == "plain" and tp.meta["stats_shape"] == (1, 1, 1)
    assert tp.wire_bytes() == jp.wire_bytes()
    for a, b in zip(_arrays(tp), _arrays(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tq.decode(cfg, tp).numpy(),
                               np.asarray(jq.decode(_jcfg(cfg), jp)),
                               rtol=0, atol=1e-6)


def test_nf_block_straddling_words_takes_the_plain_codec():
    """An NF block that does not hold whole packed words, or a width
    outside the kernel slots, has no kernel in either package: the static
    rule sends it to the flat-stream codec."""
    x = _x(5, (2, 630))
    for cfg in (QuantConfig(method="nf", bits=4, block_size=63),
                QuantConfig(method="nf", bits=2, block_size=30),
                QuantConfig(method="nf", bits=3)):
        tp = tq.encode(cfg, torch.as_tensor(x))
        jp = jq.encode(_jcfg(cfg), jnp.asarray(x), impl="pallas")
        assert not kernel_codecs.nf_has_kernel(cfg)
        assert tp.meta["impl"] == "plain" and jp.meta["impl"] == "jnp"
        assert tp.wire_bytes() == jp.wire_bytes()
        np.testing.assert_allclose(tq.decode(cfg, tp).numpy(),
                                   np.asarray(jq.decode(_jcfg(cfg), jp)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["rdfsq", "nf", "fsq", "topk"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_roundtrip_matches_wire(method, bits):
    """decode(encode(x)) == roundtrip(x)[0] (the reference's property),
    plain codecs; Top-K with the same generator seed on both sides."""
    cfg = QuantConfig(method=method, bits=bits)
    x = torch.as_tensor(_x(7, (4, 64, 32), scale=2.0))
    p = tq.encode(cfg, x, torch.Generator().manual_seed(1), impl="plain")
    y, _ = tq.roundtrip(cfg, x, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(tq.decode(cfg, p).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method,bits", [("fsq", 2), ("rdfsq", 2),
                                         ("nf", 2), ("identity", 16)])
def test_bits_per_scalar_matches_reference(method, bits):
    cfg = QuantConfig(method=method, bits=min(bits, 8))
    x = _x(8, (8, 64, 64))
    tp = tq.encode(cfg, torch.as_tensor(x))
    jp = jq.encode(_jcfg(cfg), jnp.asarray(x))
    bps = bits_per_scalar(tp, x.size)
    assert bps == j_bits_per_scalar(jp, x.size)
    assert bps == 16.0 if method == "identity" else bits <= bps < bits + 0.7


# ---------------------------------------------------------------------------
# Top-K and identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,shape", [(2, (2, 64)), (4, (3, 8, 32))])
def test_topk_deterministic_identical(bits, shape):
    cfg = QuantConfig(method="topk", bits=bits, rand_frac=0.0)
    x = _x(9, shape)
    tp = tq.encode(cfg, torch.as_tensor(x))
    jp = jq.encode(_jcfg(cfg), jnp.asarray(x), jax.random.PRNGKey(0))
    assert tp.wire_bytes() == jp.wire_bytes()
    for a, b in zip(_arrays(tp), _arrays(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tq.decode(cfg, tp).numpy(),
                                  np.asarray(jq.decode(_jcfg(cfg), jp)))
    ty, _ = tq.roundtrip(cfg, torch.as_tensor(x))
    jy, _ = jq.roundtrip(_jcfg(cfg), jnp.asarray(x), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_topk_random_picks():
    """Random picks cannot equal ``jax.random``'s: hold k, the kept
    top-magnitude entries and the 1/p scaling of the others."""
    cfg = QuantConfig(method="topk", bits=4, rand_frac=0.25)
    x = _x(11, (3, 256))
    h = 256
    k_det, k_rand = budget(cfg, h)
    assert (k_det, k_rand) == j_budget(_jcfg(cfg), h)
    y, _ = tq.roundtrip(cfg, torch.as_tensor(x), torch.Generator()
                        .manual_seed(3))
    jy, _ = jq.roundtrip(_jcfg(cfg), jnp.asarray(x), jax.random.PRNGKey(3))
    p = k_rand / (h - k_det)
    for out in (y.numpy(), np.asarray(jy)):
        for b in range(3):
            kept = out[b] != 0
            assert kept.sum() == k_det + k_rand
            top = np.argsort(-np.abs(x[b]), kind="stable")[:k_det]
            np.testing.assert_allclose(out[b][top], x[b][top], rtol=1e-3)
            rest = np.setdiff1d(np.flatnonzero(kept), top)
            np.testing.assert_allclose(out[b][rest], x[b][rest] / p,
                                       rtol=1e-3)
    a = tq.encode(cfg, torch.as_tensor(x), torch.Generator().manual_seed(5))
    b = tq.encode(cfg, torch.as_tensor(x), torch.Generator().manual_seed(5))
    assert torch.equal(a.aux["indices"], b.aux["indices"])  # seeded


def test_identity_is_16bit_and_matches_reference():
    cfg = QuantConfig(method="identity")
    x = _x(12, (2, 5, 64))
    tp = tq.encode(cfg, torch.as_tensor(x))
    jp = jq.encode(_jcfg(cfg), jnp.asarray(x))
    assert bits_per_scalar(tp, x.size) == 16.0
    assert tp.wire_bytes() == jp.wire_bytes()
    np.testing.assert_array_equal(tq.decode(cfg, tp).numpy(),
                                  np.asarray(jq.decode(_jcfg(cfg), jp)))


# ---------------------------------------------------------------------------
# grouped payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["rdfsq", "fsq", "nf"])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("scale_dq", [False, True])
def test_grouped_payload_matches_reference(method, permuted, scale_dq):
    perm = tuple(int(i) for i in np.random.default_rng(7).permutation(64)) \
        if permuted else ()
    cfg = QuantConfig(method=method, bits=2, group_widths=(1, 2, 3, 8),
                      channel_perm=perm, scale_dq=scale_dq)
    x = _x(13, (4, 6, 64))
    tp = tq.encode(cfg, torch.as_tensor(x))
    jp = jq.encode(_jcfg(cfg), jnp.asarray(x), impl="pallas")
    assert isinstance(tp, GroupedPayload) and isinstance(jp, JGrouped)
    assert tp.widths == jp.widths == (1, 2, 3, 8)
    assert tp.meta["permuted"] == jp.meta["permuted"] == permuted
    assert tp.wire_bytes() == jp.wire_bytes()
    for a, b in zip(_arrays(tp), _arrays(jp)):
        np.testing.assert_array_equal(a, b)
    ty = tq.decode(cfg, tp)
    np.testing.assert_allclose(ty.numpy(),
                               np.asarray(jq.decode(_jcfg(cfg), jp)),
                               rtol=0, atol=1e-6)
    ry, rc = tq.roundtrip(cfg, torch.as_tensor(x))
    jry, jrc = jq.roundtrip(_jcfg(cfg), jnp.asarray(x))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(rc), float(jrc), atol=1e-6)
    if not scale_dq and method != "nf":  # wire == in-graph form
        np.testing.assert_allclose(ty.numpy(), ry.numpy(), atol=1e-5)


def test_grouped_plan_validation():
    x = torch.as_tensor(_x(14, (2, 8)))
    with pytest.raises(ValueError):  # channel_perm of the wrong length
        tq.encode(QuantConfig(method="fsq", group_widths=(2, 2),
                              channel_perm=(1, 0, 2)), x)
    with pytest.raises(ValueError):  # 8 channels into 3 groups
        tq.encode(QuantConfig(method="fsq", group_widths=(2, 2, 2)), x)
    with pytest.raises(ValueError):  # a 9-bit group
        tq.encode(QuantConfig(method="fsq", group_widths=(2, 9)), x)


def test_grouped_fsq_3bit_is_3_16_of_bf16():
    cfg = QuantConfig(method="fsq", bits=2, group_widths=(3,) * 8)
    x = torch.as_tensor(_x(15, (2, 16, 64))).bfloat16()
    wire = tq.encode(cfg, x).wire_bytes()
    assert wire / (x.numel() * 2) == 3 / 16


# ---------------------------------------------------------------------------
# the split boundary with the other codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [
    QuantConfig(method="nf", bits=4), QuantConfig(method="fsq", bits=3),
    QuantConfig(method="topk", bits=2, rand_frac=0.0),
    QuantConfig(method="identity"),
    QuantConfig(method="rdfsq", bits=2, group_widths=(1, 3, 2, 2))])
def test_split_helpers_match_reference(quant):
    d = 64
    rng = np.random.default_rng(16)
    codec = dict(enc_w=np.eye(d, dtype=np.float32)
                 + 0.01 * rng.normal(size=(d, d)).astype(np.float32),
                 enc_b=np.zeros(d, np.float32),
                 dec_w=np.eye(d, dtype=np.float32),
                 dec_b=0.01 * rng.normal(size=(d,)).astype(np.float32))
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    tcfg = tsplit.SplitConfig(quant=quant)
    jcfg = jsplit.SplitConfig(quant=_jcfg(quant))
    tparams = {k: torch.as_tensor(v) for k, v in codec.items()}
    jparams = {k: jnp.asarray(v) for k, v in codec.items()}
    assert tsplit.analytic_bits_per_scalar(quant, d) == \
        jsplit.analytic_bits_per_scalar(_jcfg(quant), d)
    assert tsplit.wire_payload(tcfg, tparams, torch.as_tensor(x)
                               ).wire_bytes() == \
        jsplit.wire_payload(jcfg, jparams, jnp.asarray(x)).wire_bytes()
    ty, tc = tsplit.compressor_roundtrip(tparams, tcfg, torch.as_tensor(x))
    jy, jc = jsplit.compressor_roundtrip(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(tc), float(jc), atol=1e-6)


@pytest.mark.parametrize("method", ["fsq", "rdfsq", "nf", "topk"])
def test_ste_gradient_is_identity(method):
    cfg = QuantConfig(method=method, bits=2, commit_alpha=0.0)
    x = torch.as_tensor(_x(17, (2, 32))).requires_grad_()
    y, _ = tq.roundtrip(cfg, x, torch.Generator().manual_seed(0))
    (y * 3.0).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 3.0, atol=1e-5)
