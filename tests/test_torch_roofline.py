"""The port's analytic roofline (``repro_torch.launch.roofline``) against
the JAX reference's (``repro.launch.roofline``, ``benchmarks/roofline.py``)
on the CPU: parameter counts, serve-time weight bytes and model FLOPs for
all eleven archs, full and ``reduced()``, exactly equal; the weight-bytes
rows; and the H100 peaks as the one copy ``chip_smoke.py`` reads."""
import pytest

pytest.importorskip("jax")

import ast  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from benchmarks import roofline as jbench  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
assert len(ARCHS) == 11


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one torch thread: the suite runs a worker a core
    or so, and a pool of a thread a core in each worker oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, reduced):
    j, t = get_config(arch), torch_get_config(arch)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_bytes_and_flops_match_reference(arch, reduced):
    """Exact: the same float arithmetic in the same order."""
    jcfg, tcfg = _cfgs(arch, reduced)
    assert troof.param_counts(tcfg) == jroof.param_counts(jcfg)
    for bits, group in ((16, 128), (4, 128), (3, 128), (4, 64), (2, 32)):
        assert troof.decode_weight_bytes(tcfg, bits, group) == \
            jroof.decode_weight_bytes(jcfg, bits, group), (bits, group)
    for kind, batch, seq in (("train", 8, 4096), ("prefill", 4, 1024),
                             ("decode", 16, 2048)):
        shape = troof.StepShape(kind, batch, seq)
        # the reference reads .kind / .batch / .seq_len of its shape
        assert troof.model_flops(tcfg, shape) == \
            jroof.model_flops(jcfg, shape), kind


@pytest.mark.parametrize("bits,group", [(16, 128), (32, 1), (4, 128),
                                        (3, 128), (2, 64), (8, 16)])
def test_weight_stream_bits_matches_reference(bits, group):
    assert troof.weight_stream_bits(bits, group) == \
        jroof.weight_stream_bits(bits, group)


def test_weight_bytes_rows_match_reference(capsys):
    """The rows of ``benchmarks/roofline.py::weight_bytes_rows`` (which
    reads no dry-run artifact and writes no file), and the paper runner's
    printed rows under the same names."""
    from repro_torch.paper import run as prun

    want = jbench.weight_bytes_rows()
    ref_rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("roofline/")]
    assert troof.weight_bytes_rows() == want
    assert prun._roofline(None, None) == want
    got_rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("roofline/")]
    assert got_rows == ref_rows and len(got_rows) == 3


def test_tinyllava_count_leaves_out_norms_connector_and_codec():
    """``param_counts`` counts the blocks' matmuls, the embedding and the
    head; the model's leaves add the norms, the connector and the split
    codec, exactly."""
    cfg = torch_get_config("tinyllava").reduced()
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_count

    params = tf.init_params(cfg, seed=0, device="cpu")
    d, c, v = cfg.d_model, cfg.d_connector, cfg.d_vision
    norms = (2 * cfg.n_layers + 1) * d
    connector = v * c + c + c * d + d
    codec = 2 * (d * d + d)
    assert tree_count(params) == troof.param_counts(cfg)["total"] + norms \
        + connector + codec


def test_peaks_are_the_h100_s_and_have_one_copy():
    """The H100's data-sheet rates live in the roofline module;
    ``chip_smoke.py`` imports them and defines none of its own, and no
    TPU peak came across."""
    assert troof.HBM_BYTES_PER_S == 3.35e12
    assert troof.BF16_FLOP_PER_S == 989e12
    assert troof.NVLINK_BYTES_PER_S == 450e9
    smoke = (ROOT / "chip_smoke.py").read_text()
    assigned = {t.id for n in ast.walk(ast.parse(smoke))
                if isinstance(n, ast.Assign) for t in n.targets
                if isinstance(t, ast.Name)}
    assert not {"HBM_BYTES_PER_S", "BF16_FLOP_PER_S"} & assigned
    assert "from repro_torch.launch.roofline import" in smoke
    floats = {v for v in vars(troof).values() if isinstance(v, float)}
    assert not floats & {197e12, 819e9, 50e9}  # a TPU v5e's peaks, ICI
