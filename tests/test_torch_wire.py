"""The port's RD-FSQ wire (kernels K4 / K5 and the codecs around them)
against the JAX reference, on the CPU."""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import quantizers as tq  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ROWS, COLS = 5, 1500  # neither a multiple of the reference's 8 x 1024 tile


def _ulp(stats) -> float:
    """One float32 ulp at the scale of the (lo, hi) stats."""
    return float(np.spacing(np.abs(np.asarray(stats, np.float32)).max()))


def _x(seed, shape=(ROWS, COLS), outliers=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.2, 1.0, size=shape).astype(np.float32)
    if outliers:  # make the 3-sigma clip bite
        x.reshape(shape[0], -1)[:, :3] = 40.0
    return x


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_words_bit_identical_to_reference(bits):
    x = _x(bits)
    jwords, jstats = jops.rdfsq_quantize(jnp.asarray(x), bits)  # interpret
    twords, tstats = tops.rdfsq_quantize(torch.as_tensor(x), bits)
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    np.testing.assert_array_equal(twords.numpy(), np.asarray(jwords))
    # the plain kernel version alone, from the reference's own stats
    lo = np.asarray(jstats, np.float32)[:, :1]
    hi = np.asarray(jstats, np.float32)[:, 1:]
    cols = COLS - COLS % 8
    jr = jref.rdfsq_quantize_ref(jnp.asarray(x[:, :cols]), jnp.asarray(lo),
                                 jnp.asarray(hi), bits)
    tr = tref.rdfsq_quantize_ref(torch.as_tensor(x[:, :cols]),
                                 torch.as_tensor(lo), torch.as_tensor(hi),
                                 bits)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dequantize_exact(bits):
    """Exact against the reference formula evaluated op by op in IEEE
    float32 (numpy); within one float32 ulp of the reference's own
    wrapper, whose CPU lowering is not correctly rounded (it misses lo
    for code 0 by an ulp; ROADMAP queue F)."""
    x = _x(10 + bits)
    jwords, jstats = jops.rdfsq_quantize(jnp.asarray(x), bits)
    words = np.array(jwords)
    stats = np.array(jstats).astype(np.float32)
    half = np.float32((2 ** bits - 1) / 2.0)
    per = 8 // bits
    codes = ((words[..., None] >> (np.arange(per, dtype=np.uint8) * bits))
             & (2 ** bits - 1)).reshape(ROWS, -1)[:, :COLS]
    lo, hi = stats[:, :1], stats[:, 1:]
    c = (codes.astype(np.float32) - half) / half
    ieee = (c + np.float32(1.0)) / np.float32(2.0) * (hi - lo) + lo
    for out_dtype in (torch.float32, torch.bfloat16):
        ty = tops.rdfsq_dequantize(torch.as_tensor(words),
                                   torch.as_tensor(np.array(jstats)), bits,
                                   COLS, out_dtype=out_dtype)
        assert ty.dtype == out_dtype
        np.testing.assert_array_equal(
            ty.float().numpy(),
            torch.as_tensor(ieee).to(out_dtype).float().numpy())
    jy = np.asarray(jops.rdfsq_dequantize(jwords, jstats, bits, COLS))
    np.testing.assert_allclose(jy, ieee, rtol=0, atol=_ulp(stats))


def test_bf16_input_reads_like_its_fp32_copy():
    x = torch.as_tensor(_x(3)).bfloat16()
    w16, s16 = tops.rdfsq_quantize(x, 2)
    w32, s32 = tops.rdfsq_quantize(x.float(), 2)
    assert torch.equal(w16, w32) and torch.equal(s16, s32)


@pytest.mark.parametrize("shape", [(2, 16, 256), (3, 7, 33)])
def test_kernel_codec_matches_reference_pallas_codec(shape):
    cfg_j = get_config("tinyllava").split.quant
    cfg_t = torch_get_config("tinyllava").split.quant
    x = _x(4, shape)
    jp = jq.encode(cfg_j, jnp.asarray(x), impl="pallas")
    tp = tq.encode(cfg_t, torch.as_tensor(x))
    assert tp.meta["impl"] == "kernel" and jp.meta["impl"] == "pallas"
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.scales.numpy(), np.asarray(jp.scales))
    assert tp.wire_bytes() == jp.wire_bytes()
    # the reference's CPU dequantize is within an ulp of IEEE float32
    np.testing.assert_allclose(tq.decode(cfg_t, tp).numpy(),
                               np.asarray(jq.decode(cfg_j, jp)), rtol=0,
                               atol=_ulp(jp.scales))
    # the flat-stream encoder against the reference's jnp one
    jn = jq.encode(cfg_j, jnp.asarray(x), impl="jnp")
    tn = tq.encode(cfg_t, torch.as_tensor(x), impl="plain")
    np.testing.assert_array_equal(tn.data.numpy(), np.asarray(jn.data))
    assert tn.wire_bytes() == jn.wire_bytes()
    np.testing.assert_allclose(tq.decode(cfg_t, tn).numpy(),
                               np.asarray(jq.decode(cfg_j, jn)), rtol=0,
                               atol=_ulp(jn.scales))


def test_roundtrip_equals_decode_of_encode():
    cfg = QuantConfig(bits=2)
    x = torch.as_tensor(_x(5, (3, 4, 64)))
    x_hat, _ = tq.roundtrip(cfg, x)
    for impl in ("kernel", "plain"):
        y = tq.decode(cfg, tq.encode(cfg, x, impl=impl))
        np.testing.assert_array_equal(x_hat.numpy(), y.numpy())


def test_compressor_roundtrip_matches_reference():
    cfg_j = get_config("tinyllava").reduced()
    cfg_t = torch_get_config("tinyllava").reduced()
    d = cfg_j.d_model
    rng = np.random.default_rng(6)
    codec = dict(
        enc_w=np.eye(d, dtype=np.float32)
        + 0.01 * rng.normal(size=(d, d)).astype(np.float32),
        enc_b=0.01 * rng.normal(size=(d,)).astype(np.float32),
        dec_w=np.eye(d, dtype=np.float32)
        + 0.01 * rng.normal(size=(d, d)).astype(np.float32),
        dec_b=0.01 * rng.normal(size=(d,)).astype(np.float32))
    x = (0.1 * rng.normal(size=(2, 24, d))).astype(np.float32)
    jy, jc = jsplit.compressor_roundtrip(
        {k: jnp.asarray(v) for k, v in codec.items()}, cfg_j.split,
        jnp.asarray(x))
    ty, tc = tsplit.compressor_roundtrip(
        {k: torch.as_tensor(v) for k, v in codec.items()}, cfg_t.split,
        torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(float(tc), float(jc), atol=1e-6)


def test_unsupported_wire_configs_raise():
    """What no codec takes raises: widths outside 1-8, an unknown
    statistics axis, an unknown method or backend, a group width outside
    1-8."""
    x = torch.as_tensor(_x(7))
    with pytest.raises(ValueError, match="bits"):
        tq.encode(QuantConfig(bits=9), x)
    with pytest.raises(ValueError, match="stats_axis"):
        tq.encode(QuantConfig(bits=3, stats_axis="channel"), x)
    with pytest.raises(ValueError, match="quantizer"):
        tq.encode(QuantConfig(method="vq"), x)
    with pytest.raises(ValueError, match="impl"):
        tq.encode(QuantConfig(), x, impl="pallas")
    with pytest.raises(ValueError, match="group widths"):
        tq.encode(QuantConfig(group_widths=(2, 9, 2, 2, 2)), x)


@pytest.mark.parametrize("cfg", [
    QuantConfig(bits=3), QuantConfig(bits=5),
    QuantConfig(stats_axis="tensor"),
    QuantConfig(method="nf", bits=3), QuantConfig(method="fsq", bits=2)],
    ids=["3-bit", "5-bit", "tensor-stats", "nf-3-bit", "fsq"])
def test_configs_without_a_kernel_take_the_plain_codec(cfg):
    """Configs that no wire kernel covers encode and decode through the
    flat-stream codec, by the static rule on the config (their payloads
    say ``impl="plain"``), with the reference's bytes and values."""
    x = _x(8, (ROWS, 4, 375))
    tp = tq.encode(cfg, torch.as_tensor(x))
    assert tp.meta["impl"] == "plain"
    jcfg = jq.QuantConfig(**{f: getattr(cfg, f) for f in
                             ("method", "bits", "stats_axis")})
    jp = jq.encode(jcfg, jnp.asarray(x), impl="pallas")
    assert tp.wire_bytes() == jp.wire_bytes()
    np.testing.assert_allclose(tq.decode(cfg, tp).numpy(),
                               np.asarray(jq.decode(jcfg, jp)), rtol=0,
                               atol=1e-6)


def test_grouped_wire_mixes_kernel_and_plain_groups():
    """A grouped plan sends each group through the dispatch on its own:
    the 2- and 4-bit groups take the kernel codec, the 3-bit group the
    plain bitstream."""
    cfg = QuantConfig(group_widths=(2, 3, 4, 2))
    x = torch.as_tensor(_x(9, (ROWS, 6, 64)))
    payload = tq.encode(cfg, x)
    assert [g.meta["impl"] for g in payload.groups] == \
        ["kernel", "plain", "kernel", "kernel"]
    y = tq.decode(cfg, payload)
    ry, _ = tq.roundtrip(cfg, x)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=0, atol=1e-5)
