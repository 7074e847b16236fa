"""Carry the reference's parameters across: numpy leaves -> torch tensors.

The tests compare the port with the JAX package from the same weights,
so they never depend on the two frameworks' random generators agreeing.
The bridge imports neither ``jax`` nor ``repro``: it takes any nested
dict whose leaves ``numpy.asarray`` accepts (the reference's
``init_params`` tree does), and a packed weight store of the reference's
``repro.wq.PackedLinear``, recognised by its fields, becomes the port's
``PackedLinear`` with its uint8 codes, fp16 scales / mins and int32
``perm`` (or ``None``) as they are, whatever ``dtype`` says.
``from_jax_hub_state`` carries the reference's async-hub state across,
reading its server ``TrainState``'s ``params``, ``opt`` and ``step``; a
SplitLoRA hub's state brings its ``client_adapters`` and the server's
``"adapters"`` with it, and a SplitLoRA hub's stage-stacked parameters
(``"adapters"`` beside ``"blocks"``) cross with ``from_jax_params`` as any
other nested dict does.  ``from_jax_attack_params`` carries the
reference's feature-inversion model across, its HWIO convolution kernels
turned to the port's OIHW.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.wq.packed import PackedLinear

_PACKED_FIELDS = ("codes", "scales", "mins", "perm", "bits", "group",
                  "d_in", "d_out")


def _leaf(a, device: torch.device, dtype: Optional[torch.dtype]
          ) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy -> torch path
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree, device: DeviceLike, dtype=None) -> Dict:
    """The reference's parameter tree as the port's parameter dict, one
    leaf to one tensor with the same keys: zamba2's top-level
    ``shared_attn`` subtree and its segments' empty dicts as they are.
    ``dtype`` casts the floating leaves; ``None`` keeps each leaf's own
    dtype, so a mamba2 mixer's ``A_log``, ``D`` and ``dt_bias`` and an
    rwkv6 time mix's ``decay_base`` and ``u`` stay fp32 in a bf16 tree, as
    in the reference."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if all(hasattr(node, f) for f in _PACKED_FIELDS):
            return PackedLinear(
                codes=_leaf(node.codes, dev, None),
                scales=_leaf(node.scales, dev, None),
                mins=_leaf(node.mins, dev, None),
                perm=None if node.perm is None
                else _leaf(node.perm, dev, None),
                bits=int(node.bits), group=int(node.group),
                d_in=int(node.d_in), d_out=int(node.d_out))
        return _leaf(node, dev, dtype)

    return conv(tree)


def from_jax_hub_state(state, device: DeviceLike) -> Dict:
    """The reference's async-hub state (``schedules.init_hub_state``'s
    dict: the server's ``TrainState``, the N-stacked client blocks and
    moments, the ``(N,)`` client steps, the N-stacked calibration; a
    SplitLoRA state's N-stacked ``client_adapters`` too) as the port's
    (``repro_torch.launch.schedules.init_hub_state``'s layout), every leaf
    at its own dtype."""
    from repro_torch.train.loop import TrainState

    server = state["server"]
    return dict(
        server=TrainState(params=from_jax_params(server.params, device),
                          opt=from_jax_params(server.opt, device),
                          step=from_jax_params(server.step, device)),
        **{k: from_jax_params(state[k], device)
           for k in ("client_params", "client_adapters", "client_opt",
                     "calib") if k in state})


def from_jax_attack_params(params, device: DeviceLike) -> Dict:
    """The reference's inversion model (``repro.attack.init_attack_params``:
    HWIO kernels ``w*``, biases ``b*``) as the port's (OIHW kernels), fp32
    leaves."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        t = _leaf(v, dev, torch.float32)
        out[k] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
    return out
