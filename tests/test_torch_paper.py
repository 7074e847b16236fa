"""The port's paper experiments (``repro_torch.paper``) against the JAX
reference's (``benchmarks/table1_entropy.py``, ``table2_bits.py``,
``table3_performance.py``, ``table4_comm.py``, ``quant_bench.py::_curve``)
on the CPU at ``tinyllava.reduced()``: activations and entropies within
stated tolerances and the same optimal width; bytes exact for the payload
layout each row ships; the Table-3 config, eval and a short run on the same
weights; the curve's plans, bytes and CEs on the reference's trained
weights, and both of its claims in the port.  Weights cross with
``from_jax_params``; inputs come from numpy seeds.  No test writes a file
of the repository: the reference's curve writes under ``tmp_path``."""
import pytest

pytest.importorskip("jax")

import ast  # noqa: E402
import dataclasses  # noqa: E402
from functools import partial  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import quant_bench as jqb  # noqa: E402
from benchmarks import table1_entropy as jt1  # noqa: E402
from benchmarks import table3_performance as jt3  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import entropy as jent  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.launch import schedules as jsched  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import entropy as tent  # noqa: E402
from repro_torch.core import quantizers as tq  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.paper import quant_curve as tcurve  # noqa: E402
from repro_torch.paper import table1_entropy as tt1  # noqa: E402
from repro_torch.paper import table2_bits as tt2  # noqa: E402
from repro_torch.paper import table3_performance as tt3  # noqa: E402
from repro_torch.paper import table4_comm as tt4  # noqa: E402
from repro_torch.serve.decode import cache_length  # noqa: E402
from repro_torch.train.loop import TrainState, batch_to  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()
assert CFG.n_image_tokens == 16 and CFG.d_model == 256


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
def weights():
    """The reference's tinyllava.reduced() weights from PRNGKey(0), and the
    same carried across."""
    jp = jtf.init_params(KEY, CFG)
    return jp, from_jax_params(jp, "cpu")


# ---------------------------------------------------------------------------
# Table 1
# ---------------------------------------------------------------------------

def test_boundary_activations_match_reference(weights):
    """The connector then the codec's encoder, fp32: within 1e-5."""
    jp, tp = weights
    batch = next(jpipeline(CFG, 8, 32, seed=3))
    want = jt1.boundary_activations(CFG, jp, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    got = tt1.boundary_activations(TCFG, tp, batch_to(batch, "cpu"))
    assert got.shape == want.shape == (8, 16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_entropy_on_one_sample_set_matches_reference(weights):
    """Both estimators on every value of one batch's activations (so no
    subsample: ``max_samples`` covers n): within 1e-4 bits, the same
    width."""
    jp, _ = weights
    batch = {k: jnp.asarray(v)
             for k, v in next(jpipeline(CFG, 8, 32, seed=4)).items()}
    h = np.asarray(jt1.boundary_activations(CFG, jp, batch))
    n = h.size
    je, jd = jent.differential_entropy_bits(jnp.asarray(h), max_samples=n)
    te, td = tent.differential_entropy_bits(torch.as_tensor(h.copy()),
                                            max_samples=n)
    assert td["n"] == jd["n"] == n
    assert abs(te - je) < 1e-4, (te, je)
    assert tent.optimal_bits(te) == jent.optimal_bits(je)


def test_table1_run_gives_the_reference_s_width(weights, capsys):
    """The two runs subsample each batch differently (a torch.Generator
    against jax.random), so their means differ by sampling noise: within
    0.05 bits, where the batches themselves spread by about 0.1; the same
    optimal width and the reference's row names."""
    _, tp = weights
    want = jt1.run()
    ref_names = [ln.split(",")[0] for ln in capsys.readouterr().out
                 .splitlines() if ln.startswith("table1/")]
    got = tt1.run(device="cpu", params=tp)
    names = [ln.split(",")[0] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table1/")]
    assert names == ref_names and len(names) == 9
    jmean = float(np.mean(want["entropies"]))
    assert abs(got["mean"] - jmean) < 0.05, (got["mean"], jmean)
    assert got["optimal_bits"] == want["optimal_bits"]


# ---------------------------------------------------------------------------
# Table 2
# ---------------------------------------------------------------------------

SMALL = (2, 16, 1280)  # the table's row width, fewer rows


@pytest.fixture(scope="module")
def table2_rows():
    return tt2.run(device="cpu", shape=SMALL)


def test_table2_rows_are_the_reference_s(table2_rows):
    assert tuple(table2_rows) == tt2.rows()
    assert [k for k in table2_rows] == [
        (m, b) for m in ("fsq", "rdfsq", "nf", "topk", "identity")
        for b in ((16,) if m == "identity" else (1, 2, 3, 4))]


@pytest.mark.parametrize("method,bits", tt2.rows())
def test_table2_bits_match_reference_payload_of_same_layout(table2_rows,
                                                            method, bits):
    """Each row's measured bits and bytes against the reference's payload in
    the same layout: a kernel-layout row against ``impl="pallas"`` in
    interpret mode, a flat-stream row against ``impl="jnp"``.  The analytic
    bits are the reference's closed forms."""
    row = table2_rows[(method, bits)]
    x = np.random.default_rng(0).normal(size=SMALL).astype(np.float32)
    impl = "pallas" if row["layout"] == "kernel" else "jnp"
    assert row["layout"] == ("kernel" if (method, bits) in {
        ("rdfsq", 1), ("rdfsq", 2), ("rdfsq", 4), ("nf", 1), ("nf", 2),
        ("nf", 4)} else "plain")
    cfg = jq.QuantConfig(method=method, bits=min(bits, 8))
    ref = jq.encode(cfg, jnp.asarray(x), jax.random.PRNGKey(1), impl=impl)
    assert row["wire_bytes"] == ref.wire_bytes()
    assert row["measured"] == jcore.bits_per_scalar(ref, x.size)
    assert row["analytic"] == jcore.analytic_bits_per_scalar(
        cfg, x.size // x.shape[0])
    assert [tuple(a.shape) for a in row["payload"].arrays()] == \
        [tuple(a.shape) for a in ref.arrays()]


# ---------------------------------------------------------------------------
# Table 4
# ---------------------------------------------------------------------------

def _ref_bytes(q, shape, layout):
    """The reference payload's bytes in ``layout``, from shapes alone."""
    impl = "pallas" if layout == "kernel" else "jnp"
    enc = partial(jq.encode, jq.QuantConfig(method=q.method, bits=q.bits),
                  impl=impl)
    return jax.eval_shape(enc, jax.ShapeDtypeStruct(shape, jnp.float32)
                          ).wire_bytes()


def test_table4_bytes_match_reference_by_layout(weights, capsys):
    """Bytes per 100 batches (5 of 20 batches) exact against the reference's
    payload of each row's layout; the reduction from them; the row names
    (the reference's ICI column is the card's NVLink here)."""
    _, tp = weights
    got = tt4.run(n_batches=5, device="cpu", params=tp)
    names = [ln.split(",")[0] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table4/")]
    assert names[:8] == [f"table4/{'original' if m == 'identity' else m}_"
                         f"{b}bit" for m, b in tt4.SETTINGS] + [
        "table4/reduction_2bit_vs_16bit"]
    shape = (8, CFG.n_image_tokens, CFG.d_model)
    for method, bits in tt4.SETTINGS:
        q = tq.QuantConfig(method=method, bits=bits)
        layout = tq.encode(q, torch.zeros(shape)).meta["impl"]
        one = _ref_bytes(q, shape, layout)
        assert got[(method, bits)]["bytes"] == 5 * one, (method, bits)
        assert got[(method, bits)]["mb"] == 5 * one * 20 / 2 ** 20
    red = 1 - got[("rdfsq", 2)]["mb"] / got[("identity", 16)]["mb"]
    assert got["reduction"] == red
    # 2-bit codes and (lo, hi) fp16 a row against bf16: 1/8 plus 4 B a row
    assert red == 1 - (shape[1] * shape[2] * 2 / 8 + 4) / (
        shape[1] * shape[2] * 2)


def test_table4_hub_rows_match_reference_hub_wire_bytes():
    """``run_hub``'s rows against the reference's
    ``schedules.hub_wire_bytes`` (not its ``run_hub``, which writes a
    tracked file)."""
    got = tt4.run_hub(TCFG)
    assert sorted(got) == [1, 2, 4, 8]
    for n, row in got.items():
        quants = tuple(jq.QuantConfig(method="rdfsq", bits=2) if c % 2 == 0
                       else jq.QuantConfig(method="nf", bits=4)
                       for c in range(n))
        wire = jsched.hub_wire_bytes(CFG, jcore.HubConfig(
            n_clients=n, client_quants=quants), 8, 32)
        want = {f"{s}->{d}": v["fwd"]
                for (s, d), v in sorted(wire["links"].items())}
        assert row["links"] == want, n
        assert row["server_ingress_bytes_per_tick"] == wire["fwd_total"]
        assert row["lan_s_per_tick"] == wire["fwd_total"] / (1e9 / 8)


# ---------------------------------------------------------------------------
# Table 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,bits", tt3.SETTINGS)
def test_table3_cfg_matches_reference(method, bits):
    assert tt3.SETTINGS[0] == ("identity", 16) and len(tt3.SETTINGS) == 13
    assert dataclasses.asdict(tt3._cfg(method, bits)) == \
        dataclasses.asdict(jt3._cfg(method, bits))


def test_table3_eval_matches_reference(weights):
    """``_eval``'s CE within 1e-4 and the same accuracy, on the reference's
    weights carried across, for the 2-bit RD-FSQ setting."""
    jcfg, tcfg = jt3._cfg("rdfsq", 2), tt3._cfg("rdfsq", 2)
    jstate = jloop.init_state(KEY, jcfg, JAdamW())
    tp = from_jax_params(jstate.params, "cpu")
    want = jt3._eval(jstate, jcfg, n_batches=2)
    got = tt3._eval(TrainState(params=tp, opt={}, step=None), tcfg,
                    n_batches=2)
    assert abs(got["ce"] - want["ce"]) < 1e-4, (got, want)
    assert got["acc"] == want["acc"]


def test_table3_run_matches_reference_train_loop(monkeypatch, capsys):
    """``run`` over identity-16 and rdfsq-2 for 3 steps, one seed, from the
    reference's weights of that seed: against the reference's
    ``train_loop`` and ``_eval`` (CE within 1e-3, the same accuracy, rel
    within 1e-3)."""
    settings = (("identity", 16), ("rdfsq", 2))
    want = {}
    for method, bits in settings:
        jcfg = jt3._cfg(method, bits)
        state, _ = jloop.train_loop(jcfg, JAdamW(lr=2e-3),
                                    jpipeline(jcfg, jt3.BATCH, jt3.SEQ,
                                              seed=0),
                                    n_steps=3, seed=0, log_every=2)
        want[(method, bits)] = jt3._eval(state, jcfg)
    base = want[settings[0]]["acc"] - 0.05 * want[settings[0]]["ce"]

    def bridged(cfg, *, seed=0, device=None):
        return from_jax_params(jtf.init_params(jax.random.PRNGKey(seed),
                                               jt3._cfg("rdfsq", 2)), device)

    monkeypatch.setattr(ttf, "init_params", bridged)
    got = tt3.run(n_steps=3, settings=settings, seeds=1, device="cpu")
    rows = [ln.split(",")[0] for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("table3/")]
    assert rows == ["table3/identity_16bit", "table3/rdfsq_2bit"]
    for key in settings:
        g, w = got[key], want[key]
        assert abs(g["ce"] - w["ce"]) < 1e-3, (key, g, w)
        assert g["acc"] == w["acc"], key
        rel = 1.0 + w["acc"] - 0.05 * w["ce"] - base
        assert abs(g["rel"] - rel) < 1e-3, (key, g["rel"], rel)


# ---------------------------------------------------------------------------
# the adaptive-wire curve
# ---------------------------------------------------------------------------

def _readout_float64(state):
    """``entropy_ema_bits`` in float64 on the host, one function for both
    packages: XLA's ``log2`` separates tied channels by up to 4.8e-7."""
    p = np.asarray(state["hist"], np.float64)
    terms = np.where(p > 0.0, p * np.log2(np.maximum(p, 1e-30)), 0.0)
    return np.maximum(-terms.sum(axis=1) + np.log2(16.0 / p.shape[1]), 0.0)


@pytest.fixture(scope="module")
def ref_curve(tmp_path_factory):
    """The reference's ``_curve(fast=True)`` (120 training steps, 8 eval
    batches), its file written under a temporary ``ROOT``, with its first
    and last training states and its last EMA recorded."""
    states, emas = [], []
    apply = jloop.apply_gradients
    update = jent.update_entropy_ema

    def apply_rec(*a, **kw):
        out = apply(*a, **kw)
        states[1:] = [out[0]]  # the first step's state, then the latest
        return out

    def update_rec(*a, **kw):
        emas.append(update(*a, **kw))
        return emas[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqb, "ROOT", tmp_path_factory.mktemp("curve"))
        mp.setattr(jloop, "apply_gradients", apply_rec)
        mp.setattr(jent, "update_entropy_ema", update_rec)
        curve = jqb._curve(fast=True)
    assert len(states) == 2 and len(emas) == 4
    return curve, states, emas[-1]


def test_curve_training_step_matches_reference(weights, ref_curve):
    """One AdamW step of the uncompressed-wire CE from the same weights.
    The gradients agree to about 3e-7; Adam's g / (|g| + eps) turns that
    into up to lr / 10 where |g| is near rounding level, so every leaf is
    within 5e-4 of the reference's and at most 0.1% of the elements off by
    more than 1e-6.  (Later steps part further: at lr 5e-3 the CE falls
    6.5 -> 2.6 in 3 steps, and the parted elements feed the next
    gradients.)"""
    _, tp = weights
    _, states, _ = ref_curve
    state = tcurve.train_uncompressed(TCFG, tp, tpipeline(TCFG, 8, 32,
                                                          seed=0), 1)
    got = {"/".join(p): x.numpy()
           for p, x in tree_flatten_with_path(state.params)}
    off = total = 0
    for path, x in jax.tree_util.tree_leaves_with_path(states[0].params):
        key = "/".join(str(k.key) for k in path)
        d = np.abs(got[key] - np.asarray(x))
        assert d.max() < 5e-4, (key, d.max())
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)


@pytest.fixture(scope="module")
def on_trained(ref_curve):
    """The port's half of the curve on the reference's trained weights:
    the stream past the 120 training batches, the EMA of the next 4, the 8
    eval batches after them."""
    _, states, _ = ref_curve
    params = from_jax_params(states[-1].params, "cpu")
    pipe = tpipeline(TCFG, 8, 32, seed=0)
    for _ in range(120):
        next(pipe)
    ema = tcurve.connector_entropy_ema(TCFG, params, pipe)
    evals = [batch_to(next(pipe), "cpu") for _ in range(8)]
    return params, ema, evals


def test_curve_plans_and_bytes_match_reference(ref_curve, on_trained):
    """The port's EMA histograms within 2/N a bin of the reference's (N =
    128 samples a batch): a sample on a bin edge falls either side when
    the EMA sigma differs in its last bit, and this stream has one such
    channel.  From the reference's EMA, read by one float64 function for
    both packages, the port's plans and permutation equal the reference's;
    from the port's own EMA, the permutation equals it but for the
    channels whose histograms moved, and the widths of its own float32
    readout equal the reference's.  Side and wire bytes exact."""
    curve, _, jema = ref_curve
    _, ema, _ = on_trained
    th, jh = ema["hist"].numpy(), np.asarray(jema["hist"])
    np.testing.assert_allclose(th, jh, rtol=0, atol=2.0 / 128)
    moved = set(np.nonzero((th != jh).any(axis=1))[0].tolist())
    assert len(moved) <= 2, moved

    plans = tcurve.plan_wires(TCFG, _readout_float64(jema))
    ref_perm, ref_plan = jent.plan_grouped(
        _readout_float64(jema), plans["static2_bytes"] - curve["side_bytes"],
        group_size=CFG.d_model // jqb._N_GROUPS,
        scalars_per_channel=8 * CFG.n_image_tokens)
    assert plans["adaptive"].channel_perm == ref_perm
    assert list(plans["adaptive"].group_widths) == list(ref_plan) == \
        curve["plan"]
    assert list(plans["adaptive_dq"].group_widths) == curve["plan_dq"]
    assert plans["side_bytes"] == curve["side_bytes"]
    assert plans["side_bytes_dq"] == curve["side_bytes_dq"]

    own64 = tcurve.plan_wires(TCFG, _readout_float64(ema))
    assert [c for c in own64["adaptive"].channel_perm if c not in moved] \
        == [c for c in ref_perm if c not in moved]
    own = tcurve.plan_wires(TCFG, tent.entropy_ema_bits(ema))
    assert list(own["adaptive"].group_widths) == curve["plan"]
    assert list(own["adaptive_dq"].group_widths) == curve["plan_dq"]
    shape = (8, CFG.n_image_tokens, CFG.d_model)
    for name, wq in tcurve.settings(plans):
        got = (int(np.prod(shape)) * 2 if wq is None
               else tcurve.payload_bytes(wq, shape, torch.float32))
        assert got == curve["points"][name]["wire_bytes"], name


def test_curve_ces_match_reference_and_claims_hold(ref_curve, on_trained):
    """On the reference's trained weights and its own plans, each wire's
    held-out CE within 2e-4 of the reference's; with the port's own plans
    (its float32 readout), both of the reference's claims hold."""
    curve, _, _ = ref_curve
    params, ema, evals = on_trained
    static2 = tq.QuantConfig(method="rdfsq", bits=2)
    # both plans sort the channels by the same entropies, so the dq plan's
    # permutation is the one the reference records
    perm = tuple(curve["channel_perm"])
    ref_plans = dict(
        static2=static2,
        adaptive=dataclasses.replace(
            static2, group_widths=tuple(curve["plan"]), channel_perm=perm),
        adaptive_dq=dataclasses.replace(
            static2, group_widths=tuple(curve["plan_dq"]), channel_perm=perm,
            scale_dq=True))
    points = tcurve.curve_points(TCFG, params, evals,
                                 tcurve.settings(ref_plans))
    for name, p in points.items():
        want = curve["points"][name]
        assert abs(p["eval_ce"] - want["eval_ce"]) < 2e-4, (name, p, want)
        assert p["wire_bytes"] == want["wire_bytes"], name
    own = tcurve.plan_wires(TCFG, tent.entropy_ema_bits(ema))
    tcurve.check(tcurve.curve_points(TCFG, params, evals,
                                     tcurve.settings(own)), ce=True)


# ---------------------------------------------------------------------------
# entry points, files, imports
# ---------------------------------------------------------------------------

def _repo_files():
    """Every file under the repository's results/ and benchmarks/ and its
    BENCH_*.json, with its size and modification time."""
    paths = [p for d in ("results", "benchmarks") for p in
             (ROOT / d).rglob("*") if p.is_file() and
             "__pycache__" not in p.parts] + sorted(ROOT.glob("BENCH_*.json"))
    return {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in paths}


def test_entry_points_run_on_cpu_and_write_nothing(tmp_path, monkeypatch,
                                                   capsys):
    """``python -m repro_torch.paper.run --device cpu --only
    table2,table4,roofline`` and ``python -m repro_torch.launch.quickstart
    --device cpu --steps 3`` run, and neither writes a file: not in the
    working directory, not under results/ or benchmarks/, no
    BENCH_*.json."""
    from repro_torch.launch import quickstart
    from repro_torch.paper import run as prun

    before = _repo_files()
    monkeypatch.chdir(tmp_path)
    assert prun.main(["--device", "cpu", "--only",
                      "table2,table4,roofline"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("name,us_per_call,derived\n")
    for row in ("table2/nf_4bit,", "table4/reduction_2bit_vs_16bit,",
                "table4/hub_8clients,", "roofline/weight_bytes/granite"):
        assert row in out, row
    res = quickstart.run(steps=3, device="cpu")
    out = capsys.readouterr().out
    assert "answer-token accuracy" in out and "generated token ids" in out
    assert np.array(res["generated"]).shape == (2, quickstart.N_NEW)
    assert res["cache_len"] == 16 + 8 + 8
    assert list(tmp_path.iterdir()) == []
    assert _repo_files() == before
    with pytest.raises(SystemExit):
        prun.main(["--only", "table9"])


def test_quickstart_ring_holds_full_width_prompt():
    """At full width the ring holds 729 image tokens, 8 prompt tokens and
    8 new ones (the reference's 64 fits only reduced()'s 16 images)."""
    full = torch_get_config("tinyllava")
    assert cache_length(full, full.n_image_tokens + 8 + 8, None) == 745


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tt1.run, tt2.run, tt4.run, tcurve.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_paper_modules_import_neither_jax_repro_nor_benchmarks():
    """No module of ``repro_torch.paper`` (nor the roofline, the quickstart
    or the smoke's runner) imports ``jax``, ``repro`` or ``benchmarks``."""
    port = ROOT / "src" / "repro_torch"
    files = sorted((port / "paper").glob("*.py")) + [
        port / "launch" / "roofline.py", port / "launch" / "quickstart.py",
        ROOT / "scripts" / "smoke_phases.py", ROOT / "chip_smoke.py"]
    assert len(files) == 12
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 else []
            bad = [n for n in names
                   if n.split(".")[0] in ("jax", "repro", "benchmarks")]
            assert not bad, (path.name, bad)


def test_smoke_runs_the_paper_and_quickstart_phases():
    """``chip_smoke.py`` has phases 33 (paper) and 34 (quickstart), runs
    them in ``main`` into the width-64 paths, and its docstring lists
    them; ``scripts/smoke_phases.py`` names both."""
    smoke = (ROOT / "chip_smoke.py").read_text()
    funcs = {n.name for n in ast.parse(smoke).body
             if isinstance(n, ast.FunctionDef)}
    assert {"phase_paper", "phase_quickstart"} <= funcs
    for call in ('paths.update(_timed("paper", phase_paper))',
                 'paths.update(_timed("quickstart", phase_quickstart))'):
        assert call in smoke, call
    doc = smoke.split('"""')[1]
    for n, name in ((33, "paper"), (34, "quickstart")):
        assert f"\n{n}. {name}" in doc, n
    runner = (ROOT / "scripts" / "smoke_phases.py").read_text()
    for name in ("``paper``", "``quickstart``"):
        assert name in runner, name
