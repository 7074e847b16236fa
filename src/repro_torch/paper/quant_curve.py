"""The adaptive wire's rate / distortion curve (port of
``benchmarks/quant_bench.py::_curve`` and its ``_payload_bytes``).

On the paper's split-serve boundary, the VLM connector's activations:
tinyllava trains briefly with an uncompressed wire, which leaves the
connector's channels unequal in entropy.  The held-out CE (later batches of
the same stream) is then measured with the connector wire quantized as:
identity, static RD-FSQ at 2 / 3 / 4 bits, and the entropy-sorted grouped
plan (``channel_perm`` and ``group_widths`` from ``entropy.plan_grouped``)
whose total bytes, codes plus the per-(sample, group) scale side
information, are held at or below the static 2-bit payload's; once with
fp16 scales, once with double-quantized ones.  The claim: the adaptive
wire beats static 2-bit, in no more bytes and at a lower CE.  The
reference asserts both at ``tinyllava.reduced()``, and so does ``run``
there; at another config the bytes stay a check and the CE a finding.

The double-quantized setting goes through the real ``encode`` /
``decode`` pair (on the card K4 / K5 for its groups of width 1, 2, 4 or
8); the others through the plain STE roundtrip, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import entropy as entropy_mod
from repro_torch.core import quantizers
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import payload_bytes
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers.mlp import mlp_forward
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.paper.common import emit
from repro_torch.train.loop import TrainState, apply_gradients, batch_to
from repro_torch.train.losses import cross_entropy
from repro_torch.utils.tree import grads_or_zeros, tree_leaves, tree_map

N_GROUPS = 32
BATCH, SEQ = 8, 32
N_TRAIN = 120
LR = 5e-3
N_PROBE = 4


def vlm_loss(cfg: ArchConfig, params: Dict, batch: Dict,
             wire_q: Optional[QuantConfig]) -> torch.Tensor:
    """The whole VLM forward's CE with the connector wire quantized in the
    graph (``None``: uncompressed)."""
    dtype = tf.cdtype(cfg)
    b = dict(batch)
    feats = mlp_forward(params["connector"],
                        b.pop("image_embeds").to(dtype))
    if wire_q is not None:
        if wire_q.scale_dq:
            # the STE roundtrip keeps exact fp16 scales; the dq'd wire is
            # measured through the real encode / decode pair, so the CE
            # pays for the 8-bit scale codes it ships
            feats = quantizers.decode(wire_q, quantizers.encode(wire_q,
                                                                feats))
        else:
            feats, _ = quantizers.roundtrip(wire_q, feats)
    b["image_features"] = feats.to(dtype)
    logits, _ = tf.forward(params, cfg, b)
    return cross_entropy(logits, b["labels"])


def train_uncompressed(cfg: ArchConfig, params: Dict, pipe, n_train: int,
                       lr: float = LR) -> TrainState:
    """``n_train`` AdamW steps (constant lr, no weight decay) of the CE
    with the uncompressed connector wire, on ``pipe``'s next batches."""
    opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0)
    dev = tree_leaves(params)[0].device
    state = TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    for _ in range(n_train):
        leaves = tree_map(lambda p: p.detach().requires_grad_(),
                          state.params)
        loss = vlm_loss(cfg, leaves, batch_to(next(pipe), dev), None)
        state, _ = apply_gradients(state, grads_or_zeros(loss, leaves),
                                   opt_cfg)
    return state


@torch.no_grad()
def connector_entropy_ema(cfg: ArchConfig, params: Dict, pipe,
                          n_probe: int = N_PROBE) -> Dict:
    """The per-channel EMA histograms of the connector's features over
    ``pipe``'s next ``n_probe`` batches."""
    dev = tree_leaves(params)[0].device
    ema = entropy_mod.init_entropy_ema(cfg.d_model, device=dev)
    for _ in range(n_probe):
        img = torch.as_tensor(next(pipe)["image_embeds"]).to(dev)
        ema = entropy_mod.update_entropy_ema(
            ema, mlp_forward(params["connector"], img.to(tf.cdtype(cfg))))
    return ema


def plan_wires(cfg: ArchConfig, ent) -> Dict:
    """The static 2-bit wire and the two entropy-sorted grouped plans at
    its byte budget, from the per-channel entropies ``ent``: the code
    budget is the static payload's bytes less the grouped wire's side
    information, which does not depend on the widths."""
    dtype = tf.cdtype(cfg)
    d, n_img = cfg.d_model, cfg.n_image_tokens
    shape = (BATCH, n_img, d)
    static2 = QuantConfig(method="rdfsq", bits=2)
    static2_bytes = payload_bytes(static2, shape, dtype)
    floor = dataclasses.replace(static2, group_widths=(1,) * N_GROUPS)
    code_1bit = BATCH * n_img * d // 8
    side = payload_bytes(floor, shape, dtype) - code_1bit
    # double-quantized scales: 8-bit codes against one fp16 range per
    # payload halve the side bytes, and the allocator gets them back
    side_dq = payload_bytes(dataclasses.replace(floor, scale_dq=True),
                            shape, dtype) - code_1bit
    if not side_dq < side:
        raise ValueError(f"double-quantized side information {side_dq} B "
                         f"is not below the fp16 scales' {side} B")
    kw = dict(group_size=d // N_GROUPS, scalars_per_channel=BATCH * n_img)
    perm, plan = entropy_mod.plan_grouped(ent, static2_bytes - side, **kw)
    perm_dq, plan_dq = entropy_mod.plan_grouped(ent, static2_bytes - side_dq,
                                                **kw)
    return dict(
        static2=static2, static2_bytes=static2_bytes, side_bytes=side,
        side_bytes_dq=side_dq,
        adaptive=dataclasses.replace(static2, group_widths=plan,
                                     channel_perm=perm),
        adaptive_dq=dataclasses.replace(static2, group_widths=plan_dq,
                                        channel_perm=perm_dq, scale_dq=True))


def settings(plans: Dict) -> List[Tuple[str, Optional[QuantConfig]]]:
    """The six wires of the curve, by name."""
    static2 = plans["static2"]
    return [("identity-16bit", None),
            ("static-2bit", static2),
            ("static-3bit", dataclasses.replace(static2, bits=3)),
            ("static-4bit", dataclasses.replace(static2, bits=4)),
            ("adaptive-grouped", plans["adaptive"]),
            ("adaptive-dq-scales", plans["adaptive_dq"])]


@torch.no_grad()
def curve_points(cfg: ArchConfig, params: Dict, eval_batches: List[Dict],
                 wires: List[Tuple[str, Optional[QuantConfig]]]) -> Dict:
    """Per wire: the mean CE over ``eval_batches`` (device tensors), its
    bytes for one batch of connector features, widths and mean bits."""
    shape = (BATCH, cfg.n_image_tokens, cfg.d_model)
    points = {}
    for name, wq in wires:
        ces = [float(vlm_loss(cfg, params, b, wq)) for b in eval_batches]
        wire_bytes = (int(np.prod(shape)) * 2 if wq is None
                      else payload_bytes(wq, shape, tf.cdtype(cfg)))
        points[name] = dict(eval_ce=float(np.mean(ces)),
                            wire_bytes=wire_bytes,
                            widths=list(wq.group_widths) if wq else [],
                            bits=None if wq is None else wq.mean_bits())
        emit(f"quant/curve/{name}", 0.0,
             f"eval_ce={points[name]['eval_ce']:.4f};"
             f"wire_bytes={wire_bytes}")
    return points


def check(points: Dict, ce: bool) -> None:
    """The claim: each adaptive plan within the static 2-bit bytes and,
    when ``ce``, below its CE.  Raises if it fails."""
    st = points["static-2bit"]
    for name in ("adaptive-grouped", "adaptive-dq-scales"):
        ad = points[name]
        print(f"quant/curve {name} plan {ad['widths']}: "
              f"{ad['wire_bytes']}B ce={ad['eval_ce']:.4f} vs static-2bit "
              f"{st['wire_bytes']}B ce={st['eval_ce']:.4f}")
        if ad["wire_bytes"] > st["wire_bytes"]:
            raise RuntimeError(
                f"{name} plan exceeds the static 2-bit byte budget: "
                f"{ad['wire_bytes']} > {st['wire_bytes']}")
        if ce and not ad["eval_ce"] < st["eval_ce"]:
            raise RuntimeError(
                f"{name} plan does not beat static 2-bit CE: "
                f"{ad['eval_ce']} >= {st['eval_ce']}")


def run(cfg: Optional[ArchConfig] = None, n_train: int = N_TRAIN,
        n_eval: int = 16, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Train from ``seed``'s weights, plan and measure the curve; returns
    the reference's ``curve`` document (plans, side bytes, entropies,
    points).  ``cfg`` defaults to ``tinyllava.reduced()``, where the CE
    half of the claim is checked too."""
    reduced = get_config("tinyllava").reduced()
    cfg = cfg or reduced
    dev = resolve_device(device)
    params = tf.init_params(cfg, seed=seed, device=dev)
    pipe = make_pipeline(cfg, BATCH, SEQ, seed=seed)
    state = train_uncompressed(cfg, params, pipe, n_train)
    ema = connector_entropy_ema(cfg, state.params, pipe)
    ent = entropy_mod.entropy_ema_bits(ema)
    plans = plan_wires(cfg, ent)
    eval_batches = [batch_to(next(pipe), dev) for _ in range(n_eval)]
    points = curve_points(cfg, state.params, eval_batches, settings(plans))
    check(points, ce=cfg == reduced)
    adaptive, adaptive_dq = plans["adaptive"], plans["adaptive_dq"]
    curve = dict(config=cfg.name + (".reduced" if cfg == reduced else ""),
                 batch=BATCH, seq=SEQ,
                 boundary="connector (split-serve wire)",
                 n_train_steps=n_train, n_eval_batches=n_eval,
                 n_groups=N_GROUPS, plan=list(adaptive.group_widths),
                 channel_perm=list(adaptive.channel_perm),
                 plan_dq=list(adaptive_dq.group_widths),
                 side_bytes=int(plans["side_bytes"]),
                 side_bytes_dq=int(plans["side_bytes_dq"]),
                 entropy_bits=[round(float(v), 4) for v in ent.cpu()],
                 points=points)
    return curve
