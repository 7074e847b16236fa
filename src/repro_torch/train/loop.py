"""Training step builder + host-side loop (port of
``repro/train/loop.py``: ``TrainState``, ``init_state``,
``apply_gradients``, ``init_adapter_state``, ``apply_adapter_gradients``,
``make_train_step``, ``train_loop``).

``make_train_step(cfg, opt)`` returns ``(state, batch, rng) -> (state,
metrics)`` implementing the paper's composite objective: the forward
through K1, CE + alpha * L_comm through the in-graph RD-FSQ compressor,
the backward through K2 / K3, warmup-cosine AdamW.  PyTorch runs it
eagerly; there is no ``jit``.  SplitLoRA's state keeps AdamW moments over
the ``"adapters"`` subtree alone and steps only it
(``init_adapter_state`` / ``apply_adapter_gradients``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.losses import composite_loss
from repro_torch.utils.tree import (grads_or_zeros, tree_flatten_with_path,
                                    tree_leaves, tree_map)

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor  # int32, 0-dim, on the parameters' device


def init_state(cfg: ArchConfig, opt_cfg: AdamWConfig, *, seed: int = 0,
               device: DeviceLike = None) -> TrainState:
    """Random parameters from ``seed`` (``transformer.init_params``) on
    ``device`` (CUDA unless ``device="cpu"``), with zero moments."""
    params = tf.init_params(cfg, seed=seed, device=device)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device))


def apply_gradients(state: TrainState, grads, opt_cfg: AdamWConfig, *,
                    warmup_steps: int = 0, total_steps: int = 0,
                    donate: bool = False) -> Tuple[TrainState, Dict]:
    """Warmup-cosine scheduled AdamW update of a TrainState.
    ``total_steps == 0`` disables the schedule (constant lr).  ``donate``
    updates the state's parameters and moments in place
    (``adamw_update``)."""
    lr_scale = warmup_cosine(state.step, warmup_steps=warmup_steps,
                             total_steps=total_steps) \
        if total_steps else 1.0
    new_params, new_opt, opt_metrics = adamw_update(
        state.params, grads, state.opt, opt_cfg, lr_scale, donate=donate)
    return TrainState(params=new_params, opt=new_opt,
                      step=state.step + 1), opt_metrics


def init_adapter_state(params: Dict, opt_cfg: AdamWConfig) -> TrainState:
    """SplitLoRA's TrainState: AdamW moments over ``params["adapters"]``
    alone (``core/split_stage.init_stage_params(lora_rank=)``), so the
    optimizer state is sized by the adapters, not the frozen base."""
    if "adapters" not in params:
        raise ValueError("init_adapter_state needs params['adapters']")
    return TrainState(params=params,
                      opt=init_opt_state(params["adapters"], opt_cfg),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device))


def apply_adapter_gradients(state: TrainState, adapter_grads,
                            opt_cfg: AdamWConfig, *, warmup_steps: int = 0,
                            total_steps: int = 0, donate: bool = False
                            ) -> Tuple[TrainState, Dict]:
    """Adapter-only AdamW: steps ``params["adapters"]`` with gradients
    that mirror it, and returns every other leaf of ``state.params``
    unchanged (the same tensors: the base is bit-frozen).  ``donate``
    updates the adapters and moments in place, as ``apply_gradients``
    does."""
    ad = state.params["adapters"]
    paths = [p for p, _ in tree_flatten_with_path(ad)]
    if [p for p, _ in tree_flatten_with_path(state.opt["m"])] != paths \
            or [p for p, _ in tree_flatten_with_path(adapter_grads)] != paths:
        raise ValueError("the optimizer state and the gradients must mirror "
                         "params['adapters']")
    lr_scale = warmup_cosine(state.step, warmup_steps=warmup_steps,
                             total_steps=total_steps) \
        if total_steps else 1.0
    new_ad, new_opt, opt_metrics = adamw_update(
        ad, adapter_grads, state.opt, opt_cfg, lr_scale, donate=donate)
    return TrainState(params=dict(state.params, adapters=new_ad),
                      opt=new_opt, step=state.step + 1), opt_metrics


def batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _with_remat(cfg: ArchConfig, remat: Optional[bool],
                remat_group: Optional[int]) -> ArchConfig:
    if remat is None and remat_group is None:
        return cfg
    return dataclasses.replace(
        cfg, remat=cfg.remat if remat is None else remat,
        remat_group=cfg.remat_group if remat_group is None else remat_group)


def make_grad_fn(cfg: ArchConfig, *, window: Optional[int] = None,
                 grad_accum: int = 1, accum_dtype: str = "float32",
                 remat: Optional[bool] = None,
                 remat_group: Optional[int] = None) -> Callable:
    """``(params, batch, rng) -> (grads, metrics)`` of the composite loss:
    the gradient half of :func:`make_train_step` (same arguments)."""
    cfg = _with_remat(cfg, remat, remat_group)
    alpha = cfg.split.quant.commit_alpha
    acc_dt = _ACCUM_DTYPES[accum_dtype]

    def grad_fn(params, batch, rng):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, aux = tf.forward(leaves, cfg, batch, rng=rng, window=window)
        loss, metrics = composite_loss(logits, batch, aux, alpha)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return grads_or_zeros(loss, leaves), metrics

    def compute_grads(params, batch, rng=None):
        if grad_accum <= 1:
            return grad_fn(params, batch, rng)
        positions = batch.get("positions")
        micro = {k: v.chunk(grad_accum) for k, v in batch.items()
                 if k != "positions"}
        if any(len(v) != grad_accum for v in micro.values()):
            raise ValueError(f"batch does not split into {grad_accum} "
                             "microbatches")
        grads_acc = tree_map(
            lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device),
            params)
        metrics_acc = None
        for i in range(grad_accum):
            mb = {k: v[i] for k, v in micro.items()}
            if positions is not None:
                mb["positions"] = positions
            grads, metrics = grad_fn(params, mb, rng)
            grads_acc = tree_map(lambda a, g: a + g.to(acc_dt), grads_acc,
                                 grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
            metrics_acc = metrics if metrics_acc is None else {
                k: metrics_acc[k] + metrics[k] for k in metrics}
        return tree_map(lambda g: g / grad_accum, grads_acc), metrics_acc

    return compute_grads


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    window: Optional[int] = None,
                    total_steps: int = 10000,
                    warmup_steps: int = 100,
                    grad_accum: int = 1,
                    accum_dtype: str = "float32",
                    remat: Optional[bool] = None,
                    remat_group: Optional[int] = None,
                    donate: bool = False) -> Callable:
    """Build the train step ``(state, batch, rng=None) -> (state,
    metrics)``; the batch may be numpy (the data pipeline's) or tensors.
    ``donate`` updates the state's parameters and moments in place
    (``apply_gradients``), so no second copy of them exists during the
    update: the old state is not kept.

    ``remat`` / ``remat_group`` override the config's stack-executor
    policy (``models/stack.py``): ``remat=True`` checkpoints each layer
    body, ``remat_group=k>1`` adds two-level (sqrt-L) checkpointing.

    ``grad_accum`` > 1 splits the global batch into microbatches whose
    gradients are summed in ``accum_dtype`` (fp32, or bf16 as the
    reference allows) and averaged; positions are per sequence, so they
    are broadcast to every microbatch, not split.
    """
    compute_grads = make_grad_fn(cfg, window=window, grad_accum=grad_accum,
                                 accum_dtype=accum_dtype, remat=remat,
                                 remat_group=remat_group)

    def train_step(state: TrainState, batch: Dict,
                   rng: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict]:
        device = tree_leaves(state.params)[0].device
        grads, metrics = compute_grads(state.params,
                                       batch_to(batch, device), rng)
        state, opt_metrics = apply_gradients(state, grads, opt_cfg,
                                             warmup_steps=warmup_steps,
                                             total_steps=total_steps,
                                             donate=donate)
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


def train_loop(cfg: ArchConfig, opt_cfg: AdamWConfig, data_iter, *,
               n_steps: int, seed: int = 0, log_every: int = 10,
               window: Optional[int] = None,
               callback: Optional[Callable[[int, Dict], None]] = None,
               device: DeviceLike = None) -> Tuple[TrainState, list]:
    """Single-host training loop (examples / Table-3 runs) on ``device``
    (CUDA unless ``device="cpu"``)."""
    state = init_state(cfg, opt_cfg, seed=seed, device=device)
    step_fn = make_train_step(cfg, opt_cfg, window=window,
                              total_steps=n_steps)
    history = []
    for i in range(n_steps):
        state, metrics = step_fn(state, next(data_iter))
        if i % log_every == 0 or i == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((i, m))
            if callback:
                callback(i, m)
    return state, history
