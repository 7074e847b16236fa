"""The port's entropy-adaptive wire against the JAX reference, on the
CPU: the KDE entropy estimators, the per-channel EMA histograms, the
water-filling allocator and the sorted-grouping plans, and the serving
engine with the NF-4 wire and with the adaptive RD-FSQ wire."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import entropy as jent  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.launch import schedules as jsched  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import entropy as tent  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.launch import schedules as tsched  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _channels(seed, n, c):
    """(n, c) samples whose channels differ in spread and shape: narrow
    and wide normals, uniforms, a bimodal mix and a constant channel."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(c):
        kind = i % 5
        if kind == 0:
            cols.append(rng.normal(0, 10 ** rng.uniform(-3, 0.5), n))
        elif kind == 1:
            cols.append(rng.uniform(-1, 1, n) * rng.uniform(0.1, 3))
        elif kind == 2:
            cols.append(rng.choice([-2.0, 2.0], n) + rng.normal(0, 0.1, n))
        elif kind == 3:
            cols.append(np.full(n, rng.normal()))
        else:
            cols.append(rng.standard_t(3, n))
    return np.stack(cols, axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# KDE entropy (paper Appendix A)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,scale", [("normal", 1.0), ("normal", 512.0),
                                        ("uniform", 4.0), ("t3", 0.125)])
def test_kde_entropy_matches_reference(kind, scale):
    rng = np.random.default_rng(1)
    x = {"normal": rng.normal(size=4096), "uniform": rng.uniform(size=4096),
         "t3": rng.standard_t(3, size=3000)}[kind].astype(np.float32)
    x = x * np.float32(scale)
    te, td = tent.differential_entropy_bits(torch.as_tensor(x))
    je, jd = jent.differential_entropy_bits(jnp.asarray(x))
    assert abs(te - je) < 1e-4
    assert td["n"] == jd["n"] and abs(td["sigma"] - jd["sigma"]) < \
        1e-5 * jd["sigma"]
    tb, th = tent.estimate_optimal_bits(torch.as_tensor(x))
    jb, jh = jent.estimate_optimal_bits(jnp.asarray(x))
    assert tb == jb and abs(th - jh) < 1e-4
    td_, _ = tent.discretized_entropy_bits(torch.as_tensor(x), 0.25)
    jd_, _ = jent.discretized_entropy_bits(jnp.asarray(x), 0.25)
    assert abs(td_ - jd_) < 1e-4


def test_kde_entropy_subsamples_above_max_samples():
    """Above ``max_samples`` the port draws its own subsample (not
    ``jax.random``'s): the estimate stays that of the distribution."""
    x = torch.as_tensor(_normal(2, (16384,)))
    ent, diag = tent.differential_entropy_bits(x, max_samples=4096)
    assert diag["n"] == 4096
    assert abs(ent - 2.047) < 0.15  # H(N(0, 1)) = 0.5 log2(2 pi e)
    assert tent.differential_entropy_bits(x, max_samples=4096)[0] == ent


def test_optimal_bits_and_scott_rule():
    for h, b in ((1.8, 2), (2.3, 3), (0.2, 1), (25.0, 8), (-3.0, 1)):
        assert tent.optimal_bits(h) == jent.optimal_bits(h) == b
    assert tent.scott_bandwidth(1000, 1.3) == jent.scott_bandwidth(1000, 1.3)
    assert tent.MAX_WIRE_BITS == jent.MAX_WIRE_BITS == 8


# ---------------------------------------------------------------------------
# the EMA histograms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [0.9, 0.5])
def test_entropy_ema_matches_reference(decay):
    """Three updates from a cold start: histograms within 2/N per bin (a
    sample on a bin edge may land on either side), entropies within 1e-5,
    sigma to float32 precision.  A constant channel is the one exception
    to the per-bin bound: its centred samples are the rounding error of
    its mean, which XLA and PyTorch sum in different orders, so the whole
    channel lands in bin 31 on one side and bin 32 on the other.  Its
    histogram is one full bin on both sides, and its entropy the same."""
    c, n = 40, 96
    ts, js = tent.init_entropy_ema(c), jent.init_entropy_ema(c)
    for step in range(3):
        x = _channels(10 + step, n, c)
        const = (x == x[0]).all(axis=0)
        ts = tent.update_entropy_ema(ts, torch.as_tensor(x.reshape(4, 24, c)),
                                     decay=decay)
        js = jent.update_entropy_ema(js, jnp.asarray(x.reshape(4, 24, c)),
                                     decay=decay)
        th, jh = ts["hist"].numpy(), np.asarray(js["hist"])
        np.testing.assert_allclose(th[~const], jh[~const], rtol=0,
                                   atol=2.0 / n)
        if step == 0:  # cold start: a constant channel is one full bin
            assert const.any()
            assert (th[const].max(axis=1) == 1.0).all()
            assert (jh[const].max(axis=1) == 1.0).all()
        np.testing.assert_allclose(float(ts["sigma"]), float(js["sigma"]),
                                   rtol=1e-6)
        assert float(ts["count"]) == float(js["count"]) == step + 1
        np.testing.assert_allclose(tent.entropy_ema_bits(ts).numpy(),
                                   np.asarray(jent.entropy_ema_bits(js)),
                                   rtol=0, atol=1e-5)


def test_entropy_ema_ranks_channels_and_cold_starts():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.stack([rng.normal(0, 1e-3, 512),
                                  rng.normal(0, 1.0, 512)], axis=-1)
                        .astype(np.float32))
    a = tent.update_entropy_ema(tent.init_entropy_ema(2), x, decay=0.9)
    b = tent.update_entropy_ema(tent.init_entropy_ema(2), x, decay=0.1)
    assert torch.equal(a["hist"], b["hist"]) and float(a["count"]) == 1.0
    ent = tent.entropy_ema_bits(a).numpy()
    assert ent[0] < ent[1] and ent.min() >= 0.0


# ---------------------------------------------------------------------------
# the allocator and the plans
# ---------------------------------------------------------------------------

_SIGNALS = {
    "homogeneous": np.full(64, 1.9),
    "spread": np.random.default_rng(0).permutation(np.linspace(0.2, 3.2, 64)),
    "dead and wide": np.concatenate([np.full(32, 0.3), np.full(32, 20.0)]),
    "ties": np.repeat(np.array([0.5, 2.5, 1.5, 2.5]), 16),
}


@pytest.mark.parametrize("signal", sorted(_SIGNALS))
@pytest.mark.parametrize("budget_bits", [1.0, 2.0, 3.5, 1e9])
def test_plans_identical_to_reference(signal, budget_bits):
    ent = _SIGNALS[signal]
    kw = dict(group_size=8, scalars_per_channel=100)
    budget = budget_bits * 64 * 100 / 8
    assert tent.allocate_bits(ent, budget, **kw) == \
        jent.allocate_bits(ent, budget, **kw)
    assert tent.channel_order(ent) == jent.channel_order(ent)
    plan = tent.plan_grouped(ent, budget, **kw)
    assert plan == jent.plan_grouped(ent, budget, **kw)
    assert tent.plan_grouped(torch.as_tensor(ent), budget, **kw) == plan
    perm, widths = plan
    assert sorted(perm) == list(range(64))
    assert all(1 <= w <= tent.MAX_WIRE_BITS for w in widths)


def test_allocate_bits_floor_infeasible_raises():
    with pytest.raises(ValueError):
        tent.allocate_bits(np.full(64, 2.0), 10.0, group_size=8,
                           scalars_per_channel=100)
    with pytest.raises(ValueError):
        tent.allocate_bits(np.full(60, 2.0), 1e9, group_size=8,
                           scalars_per_channel=100)


@pytest.mark.parametrize("grouped", [False, True])
def test_replan_matches_reference(grouped):
    c = 80
    x = _channels(21, 4 * 24, c).reshape(4, 24, c)
    ts = tent.update_entropy_ema(tent.init_entropy_ema(c),
                                 torch.as_tensor(x))
    js = jent.update_entropy_ema(jent.init_entropy_ema(c), jnp.asarray(x))
    kw = dict(n_groups=8, scalars_per_channel=96)
    budget = 2.0 * x.size / 8.0
    if grouped:
        got = tsched.replan_grouped(ts, budget, **kw)
        assert got == jsched.replan_grouped(js, budget, **kw)
        assert sum(got[1]) / 8 <= 2.0
    else:
        assert tsched.replan_widths(ts, budget, **kw) == \
            jsched.replan_widths(js, budget, **kw)


# ---------------------------------------------------------------------------
# the serving engine with the NF-4 and the adaptive wire
# ---------------------------------------------------------------------------

CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()
PAGE = 8


@pytest.fixture(scope="module")
def case():
    """Four requests through two slots: two prefill batches, so the
    adaptive wire re-plans from a warm EMA on the second."""
    jp = jtf.init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(4):
        plen = int(rng.integers(3, 12))
        reqs.append((rng.integers(1, CFG.vocab_size, plen).tolist(),
                     int(rng.integers(2, 5)),
                     rng.normal(size=(CFG.n_image_tokens, CFG.d_vision))
                     .astype(np.float32)))
    need = sum(-(-(CFG.n_image_tokens + len(t) + m) // PAGE)
               for t, m, _ in reqs)
    return jp, from_jax_params(jp, "cpu"), reqs, 1 + need


def _run(engine_cls, params, cfg, reqs, n_pages, **kw):
    eng = engine_cls(params, cfg, n_slots=2, page_size=PAGE,
                     n_pages=n_pages, **kw)
    eng.shipped = _record_shipments(eng)
    rids = [eng.submit(t, max_new=m, image_embeds=img) for t, m, img in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


_WIRES = {
    "nf4": (dict(split_wire=QuantConfig(method="nf", bits=4)), {}),
    "adaptive": (dict(split_wire=QuantConfig(method="rdfsq", bits=2)),
                 dict(split_wire_budget_bits=2.0, split_plan_groups=8)),
}


def _readout_float64(state):
    """``entropy_ema_bits`` in float64 on the host, one function for both
    packages (see the adaptive engine test)."""
    p = np.asarray(state["hist"], np.float64)
    terms = np.where(p > 0.0, p * np.log2(np.maximum(p, 1e-30)), 0.0)
    return np.maximum(-terms.sum(axis=1) + np.log2(16.0 / p.shape[1]), 0.0)


def _record_shipments(engine):
    """Wrap the engine's shipment to record (rows, widths) per batch."""
    shipped = []
    ship = engine._ship_image_features

    def recording(imgs):
        out = ship(imgs)
        shipped.append((imgs.shape[0], engine.split_wire.group_widths))
        return out

    engine._ship_image_features = recording
    return shipped


@pytest.mark.parametrize("wire", sorted(_WIRES))
def test_engine_token_exact_vs_reference(case, wire, monkeypatch):
    """Token-exact against the JAX engine with its Pallas codecs (in
    interpret mode), the same wire bytes, and the same adopted plan.

    The adaptive case reads the EMA entropies out with one float64
    function on both sides.  Channels whose histograms hold the same
    multiset of counts have equal entropies, but XLA's and PyTorch's
    float32 ``log2`` and sums leave them a few ulps apart in different
    directions (106 of 256 channels here), and the stable argsort then
    orders such channels by that noise.  The float32 readouts are held to
    1e-5 by ``test_entropy_ema_matches_reference``; the unpatched plans by
    ``test_engine_adaptive_plans_agree_up_to_ties``."""
    monkeypatch.setenv("REPRO_QUANT_IMPL", "pallas")
    if wire == "adaptive":
        monkeypatch.setattr(jent, "entropy_ema_bits", _readout_float64)
        monkeypatch.setattr(tent, "entropy_ema_bits", _readout_float64)
    jp, tp, reqs, n_pages = case
    tkw, extra = _WIRES[wire]
    jkw = dict(split_wire=jq.QuantConfig(
        **{k: getattr(tkw["split_wire"], k)
           for k in ("method", "bits")}), **extra)
    ref, jeng = _run(JaxServeEngine, jp, CFG, reqs, n_pages, **jkw)
    out, teng = _run(ServeEngine, tp, TCFG, reqs, n_pages, device="cpu",
                     **tkw, **extra)
    assert out == ref
    assert [len(o) for o in out] == [m for _, m, _ in reqs]
    assert teng.stats["wire_bytes"] == jeng.stats["wire_bytes"] > 0
    for key in ("prefill_batches", "decode_ticks", "tokens_emitted"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.shipped == jeng.shipped
    n_img, d = CFG.n_image_tokens, CFG.d_model
    if wire == "nf4":  # 35 B per block of 64 + 2 B per 256 blocks
        nbs = [r * n_img * d // 64 for r, _ in teng.shipped]
        assert teng.stats["wire_bytes"] == sum(35 * nb + 2 * -(-nb // 256)
                                               for nb in nbs)
        assert "wire_plan" not in teng.stats
    else:  # each group's codes + its per-row fp16 (lo, hi)
        gs = d // 8
        assert teng.stats["wire_bytes"] == sum(
            r * sum(n_img * gs * w // 8 + 4 for w in widths)
            for r, widths in teng.shipped)
        plan = teng.stats["wire_plan"]
        assert plan == jeng.stats["wire_plan"]
        assert teng.split_wire.channel_perm == jeng.split_wire.channel_perm
        assert plan == teng.split_wire.group_widths and len(plan) == 8
        assert all(1 <= w <= 8 for w in plan) and sum(plan) / 8 <= 2.0
        assert sorted(teng.split_wire.channel_perm) == list(range(d))
    teng.page_pool.check_invariants()
    assert teng.page_pool.n_live == 0


def test_engine_adaptive_plans_agree_up_to_ties(case, monkeypatch):
    """With each package's own float32 readout: the same widths at every
    shipment, and a channel permutation that sorts the port's entropies
    ascending and the reference's within 1e-5 (they differ only in the
    order of channels whose entropies tie up to rounding)."""
    monkeypatch.setenv("REPRO_QUANT_IMPL", "pallas")
    jp, tp, reqs, n_pages = case
    wire = dict(split_wire_budget_bits=2.0, split_plan_groups=8)
    jeng = JaxServeEngine(jp, CFG, n_slots=2, page_size=PAGE,
                          n_pages=n_pages,
                          split_wire=jq.QuantConfig(method="rdfsq", bits=2),
                          **wire)
    teng = ServeEngine(tp, TCFG, n_slots=2, page_size=PAGE, n_pages=n_pages,
                       device="cpu", split_wire=QuantConfig(method="rdfsq",
                                                            bits=2), **wire)
    imgs = np.stack([img for _, _, img in reqs[:2]])
    with torch.inference_mode():
        for _ in range(2):  # a cold and a warm EMA update
            jeng._ship_image_features(jnp.asarray(imgs))
            teng._ship_image_features(torch.as_tensor(imgs))
            assert teng.split_wire.group_widths == \
                jeng.split_wire.group_widths
            jent_ = np.asarray(jent.entropy_ema_bits(jeng._wire_ema))
            tent_ = tent.entropy_ema_bits(teng._wire_ema).numpy()
            np.testing.assert_allclose(tent_, jent_, rtol=0, atol=1e-5)
            tperm = list(teng.split_wire.channel_perm)
            jperm = list(jeng.split_wire.channel_perm)
            assert sorted(tperm) == list(range(CFG.d_model))
            assert (np.diff(tent_[tperm]) >= 0).all()
            np.testing.assert_allclose(jent_[tperm], jent_[jperm], rtol=0,
                                       atol=1e-5)
    assert teng.stats["wire_bytes"] == jeng.stats["wire_bytes"]


def test_engine_grouped_wire_bytes(case):
    """A fixed grouped wire ships a GroupedPayload per prefill batch:
    each group's codes (odd widths on the exact bitstream) plus its
    per-row fp16 (lo, hi)."""
    _, tp, reqs, n_pages = case
    wire = QuantConfig(method="rdfsq", bits=2, group_widths=(1, 2, 3, 8))
    out, eng = _run(ServeEngine, tp, TCFG, reqs, n_pages, device="cpu",
                    split_wire=wire)
    assert [len(o) for o in out] == [m for _, m, _ in reqs]
    gs = CFG.d_model // 4
    row = sum(CFG.n_image_tokens * gs * w // 8 + 4 for w in (1, 2, 3, 8))
    assert eng.stats["wire_bytes"] == eng.stats["prefill_rows"] * row


def test_engine_budget_needs_a_wire(case):
    _, tp, _, n_pages = case
    with pytest.raises(ValueError, match="split_wire"):
        ServeEngine(tp, TCFG, n_slots=2, page_size=PAGE, n_pages=n_pages,
                    device="cpu", split_wire_budget_bits=2.0)
