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


# ---------------------------------------------------------------------------
# the vector path's methods, as plain models (csrc/rdfsq.cu)
# ---------------------------------------------------------------------------

def _k5_table_model(words, stats, bits, n_cols, out_dtype):
    """K5's vector path in torch: the row's 2^bits outputs by the kernel's
    op order, expanded into a 256-entry table (byte -> its 8 / bits
    outputs, code i of a byte first at i), gathered by the word bytes."""
    per = 8 // bits
    half = (2 ** bits - 1) / 2.0
    lo, hi = stats[:, :1].float(), stats[:, 1:].float()
    codes = torch.arange(2 ** bits, dtype=torch.float32)[None, :]
    c = tref.div_exact(codes - half, half)
    levels = ((c + 1.0) / 2.0 * (hi - lo) + lo).to(out_dtype)  # (R, 2^b)
    byte = torch.arange(256)[:, None]
    shifts = torch.arange(per)[None, :] * bits
    slots = (byte >> shifts) & (2 ** bits - 1)  # (256, per)
    table = levels[:, slots]  # (R, 256, per)
    rows = torch.arange(words.shape[0])[:, None]
    out = table[rows, words.long()]  # (R, CW, per)
    return out.reshape(words.shape[0], -1)[:, :n_cols]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dequantize_table_model_exact(bits, out_dtype):
    """K5's byte -> outputs table gives dequantize_plain's outputs and the
    reference formula's in IEEE float32 (numpy), bit for bit."""
    x = _x(20 + bits)
    words, stats16 = tops.rdfsq_quantize(torch.as_tensor(x), bits)
    stats = stats16.float()
    y = _k5_table_model(words, stats, bits, COLS, out_dtype)
    plain = tops.dequantize_plain(words, stats, bits, COLS, out_dtype)
    assert torch.equal(y, plain)
    half = np.float32((2 ** bits - 1) / 2.0)
    w = words.numpy()
    codes = ((w[..., None] >> (np.arange(8 // bits, dtype=np.uint8) * bits))
             & (2 ** bits - 1)).reshape(ROWS, -1)[:, :COLS]
    s = stats.numpy()
    lo, hi = s[:, :1], s[:, 1:]
    c = (codes.astype(np.float32) - half) / half
    ieee = (c + np.float32(1.0)) / np.float32(2.0) * (hi - lo) + lo
    np.testing.assert_array_equal(
        y.float().numpy(), torch.as_tensor(ieee).to(out_dtype).float().numpy())


SERVE, GROUP = (4, 729 * 1280), (4, 729 * 160)


@pytest.mark.parametrize("cols,bits,dtype,offset,path", [
    (SERVE[1], 2, torch.bfloat16, 0, "vector"),
    (GROUP[1], 2, torch.bfloat16, 0, "vector"),
    (GROUP[1], 4, torch.bfloat16, 0, "vector"),
    (GROUP[1], 1, torch.bfloat16, 0, "scalar"),  # 14 580 B of words a row
    (1001, 2, torch.float32, 0, "scalar"),  # 4 004 B of values a row
    (4096, 2, torch.bfloat16, 2, "scalar"),  # a view 2 bytes off
    (4092, 1, torch.float32, 0, "vector"),  # a ragged last group
], ids=["serve", "group", "group-4bit", "group-1bit", "3x1001",
        "misaligned-view", "ragged-group"])
def test_rdfsq_path(cols, bits, dtype, offset, path):
    """The path rule: 16-byte-aligned dense rows and 8-byte-aligned word
    rows take the vector path, anything else the scalar one."""
    assert tops.rdfsq_path(cols, bits, dtype, (1 << 20) + offset,
                           1 << 20) == path
    if cols < 5000:  # the same through a real (CPU) tensor's address
        flat = torch.zeros(3 * cols + 8, dtype=dtype)
        x = flat[offset // flat.element_size():][:3 * cols].view(3, cols)
        words = torch.zeros((3, -(-cols // (8 // bits))), dtype=torch.uint8)
        assert tops.rdfsq_path(cols, bits, dtype, x.data_ptr(),
                               words.data_ptr()) == path


def test_rdfsq_path_refuses_a_misaligned_word_row():
    assert tops.rdfsq_path(4096, 2, torch.bfloat16, 1 << 20,
                           (1 << 20) + 4) == "scalar"


_F32 = np.float32


def _fsq_codes(v, lo, hi, den, half):
    """K4's op sequence in IEEE float32 (numpy), NaN clipped to lo as
    fmaxf does."""
    v = np.asarray(v, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        c = np.fmin(np.fmax(v, lo), hi)
        q = (_F32(2.0) * (c - lo)) / den
        z = np.rint(half * (q - _F32(1.0)) - _F32(0.5)) + _F32(0.5)
        z = np.fmin(np.fmax(z, -half), half)
        return (z + half).astype(np.int64)


def _key(f):
    b = int(np.asarray(f, np.float32).view(np.int32))
    return b if b >= 0 else b ^ 0x7fffffff


def _key_float(k):
    k = int(k)
    return np.array(k if k >= 0 else k ^ 0x7fffffff,
                    np.int64).astype(np.int32).view(np.float32)[()]


def _code_threshold(k, lo, hi, den, half, miss=0.0):
    """K4's per-row threshold search, lane for lane: the least float
    (in key order) whose code reaches k, or NaN.  ``miss`` moves the
    first round's bracket by that many widths, off the threshold, so that
    the search starts again from [lo, hi]."""
    def holds(keys):
        return _fsq_codes([_key_float(p) for p in keys], lo, hi, den,
                          half) >= k

    est = lo + (_F32(k) - _F32(0.5)) * den / (_F32(2.0) * half)
    d = _F32(2.0 ** -21) * (den + np.abs(lo) + np.abs(est))
    est = est + _F32(2 * miss) * d
    L, H = _key(np.fmax(est - d, lo)), _key(np.fmin(est + d, hi))
    n = H - L
    pts = [L + ((n * i) >> 5) for i in range(31)] + [H]
    m = holds(pts)
    if n > 0 and not m[0] and m[31]:
        f = int(np.argmax(m))
        H, L = pts[f], pts[f - 1]
    else:
        if not holds([_key(hi)])[0]:
            return _F32(np.nan)
        L, H = _key(lo), _key(hi)
    while H - L > 1:
        n = H - L
        f = int(np.argmax(holds([L + ((n * (i + 1)) >> 5)
                                 for i in range(32)])))
        H, L = L + ((n * (f + 1)) >> 5), (L + ((n * f) >> 5) if f else L)
    return _key_float(H)


def _bf16_up(t):
    """The least bf16 >= t (__float2bfloat16_ru); NaN stays NaN."""
    r = torch.tensor([t]).to(torch.bfloat16)
    if np.isnan(t) or r.float().item() >= t:
        return r
    raw = int(r.view(torch.int16))
    raw = 1 if r.item() == 0 else raw + 1 if r.item() > 0 else raw - 1
    return torch.tensor([raw], dtype=torch.int16).view(torch.bfloat16)


# (lo, hi) rows: the serve path's, an offset row, a short span, a row
# whose middle threshold sits at about zero, a degenerate row, a huge one
_THRESHOLD_ROWS = [(-2.1, 2.3), (1000.0, 1000.5), (-3e-7, 4e-7),
                   (-0.7, 0.7), (0.25, 0.25), (-3e30, 1e30)]


@pytest.mark.parametrize("bits", [1, 2])
def test_quantize_threshold_model_matches_reference(bits):
    """K4's vector path at 1 and 2 bits: an element's code is the number
    of the row's thresholds at or below it.  On every float32 pattern
    within 64 ulps of each threshold, and NaN, +-inf, +-0, lo and hi, it
    equals rdfsq_codes_ref; so does the paired bf16 compare against the
    thresholds rounded up to bf16, on every bf16 value within 64 bf16
    ulps of them."""
    half = _F32((2 ** bits - 1) / 2.0)
    for lo, hi in _THRESHOLD_ROWS:
        lo, hi = _F32(lo), _F32(hi)
        den = (hi - lo) + _F32(1e-6)
        thr = [_code_threshold(k, lo, hi, den, half)
               for k in range(1, 2 ** bits)]
        for miss in (-3.0, 3.0):  # a bracket that misses: [lo, hi]
            np.testing.assert_array_equal(
                thr, [_code_threshold(k, lo, hi, den, half, miss)
                      for k in range(1, 2 ** bits)])
        keys = {_key(v) for v in (lo, hi, 0.0, -0.0, np.inf, -np.inf)}
        for t in thr:
            if not np.isnan(t):
                keys |= set(range(_key(t) - 64, _key(t) + 65))
        xs = np.array([_key_float(k) for k in sorted(keys)] + [np.nan],
                      np.float32)
        with np.errstate(invalid="ignore"):
            model = sum((xs >= t).astype(np.int64) for t in thr)
        ref = tref.rdfsq_codes_ref(torch.as_tensor(xs)[None, :],
                                   torch.tensor([[lo]]), torch.tensor([[hi]]),
                                   bits)[0].numpy()
        np.testing.assert_array_equal(model, ref, err_msg=f"{lo}, {hi}")
        # bf16 values against the thresholds rounded up to bf16, the
        # 2-bit code as b1 = [x >= t2], b0 = [x >= t1] ^ [x >= t2] ^ [x >= t3]
        up = [_bf16_up(t) for t in thr]
        bkeys = set()
        for u in up:
            b = int(u.view(torch.int16))
            bkeys |= set(range(b - 64, b + 65))
        xb = torch.tensor(sorted(k for k in bkeys if -32768 <= k < 32768),
                          dtype=torch.int16).view(torch.bfloat16)
        masks = [(xb >= u) for u in up]
        if bits == 1:
            code = masks[0].long()
        else:
            code = masks[1].long() * 2 + (masks[0] ^ masks[1] ^ masks[2])
        ref = tref.rdfsq_codes_ref(xb.float()[None, :], torch.tensor([[lo]]),
                                   torch.tensor([[hi]]), bits)[0]
        assert torch.equal(code.to(torch.uint8), ref), (lo, hi)
