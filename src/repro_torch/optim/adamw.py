"""AdamW from scratch (port of ``repro/optim/adamw.py``).

Global-norm gradient clipping, decoupled weight decay (skipped for 1-D
params: norms and biases), and a configurable moment dtype.  Parameters
keep their dtype: the update runs in fp32 and is cast back, as in the
reference.  The update is functional (new tensors), like the reference's,
so a state can be stepped twice from the same point.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.utils.tree import tree_bytes, tree_leaves, tree_map

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and an
    int32 step counter on the parameters' device."""
    dt = _MOMENT_DTYPES[cfg.moment_dtype]
    device = tree_leaves(params)[0].device
    return dict(
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def param_bytes(tree) -> int:
    """Byte size of a parameter tree."""
    return tree_bytes(tree)


def opt_state_bytes(state: Dict[str, Any]) -> int:
    """Byte size of an AdamW state (m + v moments + step)."""
    return (param_bytes(state["m"]) + param_bytes(state["v"])
            + param_bytes(state["step"]))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _decay_mask(params):
    """Weight decay only on >=2-D weights (not norms, biases, scalars)."""
    return tree_map(lambda p: p.ndim >= 2, params)


@torch.no_grad()
def adamw_update(params, grads, state: Dict, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Any, Dict, Dict]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    step = state["step"] + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=stepf.device)

    def upd(p, g, m, v, decay):
        gf = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        m_hat = m_new / b1c
        v_hat = v_new / b2c
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, params, grads, state["m"], state["v"],
                   _decay_mask(params))  # leaves: (p, m, v) tuples
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    metrics = dict(grad_norm=gnorm, lr=lr)
    return new_p, dict(m=new_m, v=new_v, step=step), metrics
