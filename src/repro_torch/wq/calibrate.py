"""GPTQ calibration: per-site Hessians from a small activation sample
(port of ``repro/wq/calibrate.py``).

GPTQ needs ``H = X^T X`` of each projection's *inputs* on calibration
data.  The blocks run layer by layer through the port's own
``transformer._embed_inputs``, ``block_forward`` and
``core/split.py::compressor_roundtrip``, with every 2-D w* site of the
layer wrapped in a :class:`_Tap`: an object that meets the weight contract
(``.to(dtype)`` and ``x @ w``) and adds ``X^T X`` in fp32 to its sink the
moment the forward consumes it.  The sinks live on the activations'
device; a float32 product there is a full float32 product (TF32 stays off,
as ``resolve_device`` sets it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import is_weight_site

__all__ = ["collect_hessians"]


class _Tap:
    """Weight wrapper recording ``X^T X`` of everything matmul'd into it."""

    def __init__(self, w: torch.Tensor, sink: torch.Tensor):
        self._w = w
        self._sink = sink
        self._dt = w.dtype

    @property
    def ndim(self) -> int:
        return self._w.ndim

    @property
    def shape(self):
        return self._w.shape

    def to(self, dtype):
        self._dt = dtype
        return self

    def __rmatmul__(self, x):
        x2 = x.reshape(-1, self.shape[-2]).float()
        self._sink += x2.T @ x2
        return x @ self._w.to(self._dt)


def _tap_block(p: Dict, path: Tuple[str, ...], layer: Optional[int],
               sinks: Dict) -> Dict:
    """Per-layer block params with every 2-D w* leaf wrapped in a tap."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _tap_block(v, path + (k,), layer, sinks)
        elif is_weight_site(k, v) and v.ndim == 2:
            sink = sinks.setdefault(
                (path + (k,), layer),
                torch.zeros((v.shape[-2], v.shape[-2]), dtype=torch.float32,
                            device=v.device))
            out[k] = _Tap(v, sink)
        else:
            out[k] = v
    return out


def _slice_layer(v, layer: int):
    if isinstance(v, dict):
        return {k: _slice_layer(x, layer) for k, x in v.items()}
    return v[layer]


@torch.inference_mode()
def collect_hessians(params: Dict, cfg, batch: Dict, *,
                     window: Optional[int] = None) -> Dict:
    """Run ``batch`` through the stacks, tapping every w* site.

    ``batch``: the data pipeline's numpy (or tensor) batch; it is moved to
    the params' device.  Returns ``{site_path: H}`` keyed by the full params
    path (e.g. ``("server", "seg0", "attn", "wq")``) with ``H`` a
    layer-stacked ``(n, d_in, d_in)`` float32 numpy array: the shapes
    :func:`repro_torch.wq.quantize.quantize_params` consumes.
    """
    # imported here: models/stack.py imports this package's PackedLinear
    from repro_torch.core import split as split_mod
    from repro_torch.models import transformer as tf

    tf._check_supported(cfg)
    dev = params["embed"]["emb"].device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    x = tf._embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    sinks: Dict = {}

    def run_side(side: str, side_segs, x):
        for i, (t, n) in enumerate(side_segs):
            stacked = params[side][f"seg{i}"]
            for layer in range(n):
                p = _tap_block(_slice_layer(stacked, layer),
                               (side, f"seg{i}"), layer, sinks)
                x, _, _ = tf.block_forward(cfg, p, x, positions=positions,
                                           window=window, block_type=t)
        return x

    client_segs, server_segs = cfg.client_server_segments()
    x = run_side("client", client_segs, x)
    x, _ = split_mod.compressor_roundtrip(params.get("codec"), cfg.split, x)
    run_side("server", server_segs, x)

    # stack the per-layer sinks back into the site-path keyed dict
    by_path: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for (path, layer), h in sinks.items():
        by_path.setdefault(path, {})[layer] = h
    return {path: np.stack([layers[i].cpu().numpy()
                            for i in sorted(layers)])
            for path, layers in by_path.items()}
