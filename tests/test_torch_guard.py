"""The port imports neither ``jax`` nor the reference package ``repro``."""
import pytest

pytest.importorskip("jax")

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serve.engine, repro_torch.bridge, "
            "repro_torch.kernels.build, repro_torch.train.loop, "
            "repro_torch.launch.train, repro_torch.launch.e2e, "
            "repro_torch.checkpoint, repro_torch.serve.decode, "
            "repro_torch.launch.serve_batched, repro_torch.launch.schedules, "
            "repro_torch.launch.split_hub, "
            "repro_torch.core.entropy, repro_torch.core.quantizers.nf, "
            "repro_torch.wq; "
            # the async hub's path, run: its imports happen in calls
            "from repro_torch.launch import split_hub as sh; "
            "from repro_torch.configs import get_config; "
            "from repro_torch.core.quantizers import QuantConfig as Q; "
            "cfg = get_config('llama3_2_3b').reduced(); "
            "hub = sh.HubConfig(n_clients=2, client_quants=(Q(), "
            "Q(method='nf', bits=4)), bwd_quant=Q(), tick_rates=(1, 2)); "
            "sh.train_hub(cfg, hub, sh.AdamWConfig(), "
            "[(t[0], l[0]) for t, l in sh.make_batches(cfg, 2, 1, 2, 1, 8)],"
            " micro_batch=1, seq=8, mode='async', n_ticks=2, device='cpu'); "
            # the SplitLoRA hub and the packed stage, run likewise
            "lora = sh.HubConfig(n_clients=2, grad_quant=sh.GRAD_QUANT); "
            "out = sh.train_hub(cfg, lora, sh.AdamWConfig(), "
            "sh.make_batches(cfg, 1, 1, 2, 1, 8), micro_batch=1, seq=8, "
            "lora_rank=2, device='cpu'); "
            "from repro_torch.core.split_stage import quantized_stage_blocks;"
            " quantized_stage_blocks(out['params'], 2, 'int4'); "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
