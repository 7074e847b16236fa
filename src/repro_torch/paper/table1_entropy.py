"""Paper Table 1 and Appendix A: the KDE entropy of the boundary
activations (port of ``benchmarks/table1_entropy.py``).

H(X) of the client -> server activations over ``n_batches`` batches of
tinyllava, and from the mean the optimal width by Shannon's source coding
theorem (the paper: about 1.80 - 1.84 bits, so 2 bits).  Above 4 096
values ``differential_entropy_bits`` subsamples with a ``torch.Generator``
seeded with the batch index, not with ``jax.random``, so a batch's
estimate is not the reference's sample for sample.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.entropy import differential_entropy_bits, optimal_bits
from repro_torch.core.split import client_encode_pre
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers.mlp import mlp_forward
from repro_torch.paper.common import emit, time_fn
from repro_torch.train.loop import batch_to

BATCH, SEQ = 8, 32


@torch.no_grad()
def boundary_activations(cfg: ArchConfig, params: Dict, batch: Dict
                         ) -> torch.Tensor:
    """The client's features right before the quantizer (the paper's cut
    is after the connector): the connector in fp32, then the learnable
    codec's encoder."""
    img = mlp_forward(params["connector"], batch["image_embeds"].float())
    return client_encode_pre(params.get("codec"), cfg.split, img)


def run(cfg: Optional[ArchConfig] = None, n_batches: int = 8, seed: int = 0,
        device: DeviceLike = None, params: Optional[Dict] = None) -> Dict:
    """Per-batch entropies, their mean and spread, and the optimal width of
    the mean.  ``cfg`` defaults to ``tinyllava.reduced()``, as the
    reference's; ``params`` (at least ``connector`` and, with a learnable
    codec, ``codec``) default to a draw from ``seed`` on ``device``."""
    cfg = cfg or get_config("tinyllava").reduced()
    dev = resolve_device(device)
    if params is None:
        params = tf.init_params(cfg, seed=seed, device=dev)
    pipe = make_pipeline(cfg, batch_size=BATCH, seq_len=SEQ, seed=seed)
    ents = []
    t_us = None
    for i in range(n_batches):
        h = boundary_activations(cfg, params, batch_to(next(pipe), dev))
        if t_us is None:
            t_us = time_fn(differential_entropy_bits, h, iters=3, warmup=1)
        ent, _ = differential_entropy_bits(h, seed=i)
        ents.append(ent)
        emit(f"table1/entropy_batch{i + 1}", t_us, f"H={ent:.4f}bits")
    mean_ent = sum(ents) / len(ents)
    bits = optimal_bits(mean_ent)
    spread = max(ents) - min(ents)
    emit("table1/optimal_bits", t_us,
         f"mean_H={mean_ent:.4f};spread={spread:.4f};optimal_bits={bits}")
    return dict(entropies=ents, mean=mean_ent, spread=spread,
                optimal_bits=bits)
