"""Mixture-of-Experts with grouped, sort-based capacity dispatch (port of
``repro/models/layers/moe.py``).

Token-choice top-k routing with a static per-expert capacity, dispatched
per token group:

  1. tokens reshaped to (G, T/G, D), G = ``_pick_groups(T, n)``, the
     largest divisor of T up to n = max(``GROUPS``, the data-parallel
     ranks of an installed mesh: ``sharding.ctx.dp_size``), as the
     reference picks it,
  2. the router in fp32 whatever the parameter dtype; top-k experts per
     token, gates renormalized with ``+ 1e-9``,
  3. a stable per-group sort of the (token, expert) copies by expert id;
     position-in-expert by ``searchsorted``; copies past the per-group
     capacity ``max(1, int(tk * capacity_factor / E))`` are dropped,
  4. a scatter into a (G, E * cap + 1, D) buffer whose last row takes the
     drops, one batched product per expert weight against the stacked
     experts (``torch.matmul`` over the expert axis: plain large matmuls,
     no TPU kernel stands behind them), a gather back,
  5. the combine in place of ``segment_sum``: each token's k copies,
     gathered through the sort's inverse permutation, added onto zero one
     at a time in the compute dtype in ascending expert id, the order in
     which the reference's ``segment_sum`` meets them in the sorted copies.
     No atomics: the same bits on every run at any k (``index_add`` on
     CUDA adds with atomics, whose order moves the bits from top-3 on),
     and at top-2 the bits of ``index_add`` onto zero (0 + a + b equals
     0 + b + a).  The copies of the tokens (step 4's rows) are gathered
     through the sort's permutation of each token repeated k times, so the
     backward sums a token's k gradients as a reduction, not with atomics.

Every expert's slot buffer is computed, filled or not, as in the
reference, so a decode step reads every expert's weights.

Auxiliaries: the switch-style load balance over each token's selected
router probabilities, the router z-loss, and the drop fraction.

``route`` and ``dispatch`` are the routing and the capacity decision on
their own, so tests can hold the chosen experts and the kept copies
against the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.mlp import swiglu_forward
from repro_torch.sharding import ctx as shard_ctx


def init_moe_params(n: int, d_model: int, n_experts: int, d_ff: int,
                    normal, const, *, n_shared_experts: int = 0,
                    dense_residual_d_ff: int = 0) -> Dict:
    """``n`` layer-stacked MoE feed-forwards with the reference's shapes
    and scales.  ``normal(*shape, scale=, dtype=, per_expert=)`` draws a
    leaf (the router in fp32; the stacked experts one expert at a time,
    so no fp32 copy of a whole stack is ever made)."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    p = dict(
        router=normal(n, d_model, n_experts, scale=s_in,
                      dtype=torch.float32),
        w_gate=normal(n, n_experts, d_model, d_ff, scale=s_in,
                      per_expert=True),
        w_up=normal(n, n_experts, d_model, d_ff, scale=s_in,
                    per_expert=True),
        w_down=normal(n, n_experts, d_ff, d_model, scale=s_out,
                      per_expert=True),
    )

    def swiglu(f):
        return {"w_gate": normal(n, d_model, f, scale=s_in),
                "w_up": normal(n, d_model, f, scale=s_in),
                "w_down": normal(n, f, d_model, scale=f ** -0.5)}

    if n_shared_experts > 0:
        p["shared"] = swiglu(n_shared_experts * d_ff)
    if dense_residual_d_ff > 0:
        p["dense_residual"] = swiglu(dense_residual_d_ff)
    return p


def moe_aux_losses(logits: torch.Tensor, probs: torch.Tensor,
                   expert_ids: torch.Tensor, n_experts: int) -> Dict:
    """Switch-style load balance + router z-loss.

    ``load_balance = E * mean_t(mean prob of token t's top-k experts)``,
    >= 1 for any router, 1 for a uniform one; tokens dropped by capacity
    count, since the router chose them."""
    sel_probs = torch.gather(probs, -1, expert_ids).float()
    load_balance = n_experts * torch.mean(sel_probs)
    z = torch.logsumexp(logits, dim=-1)
    return dict(load_balance=load_balance, router_z=torch.mean(z * z))


GROUPS = 16   # the reference's preferred group count


def _pick_groups(t: int, preferred: int = GROUPS) -> int:
    """Largest divisor of t that is <= preferred."""
    g = min(preferred, t)
    while t % g:
        g -= 1
    return max(g, 1)


def capacity(tg: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group."""
    return max(1, int(tg * top_k * capacity_factor / n_experts))


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int):
    """(logits, probs, gate values renormalized, expert ids), each (G, TG,
    ...): the router in fp32 on ``xg`` (G, TG, D)."""
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    return logits, probs, gate_vals, expert_ids


def dispatch(expert_ids: torch.Tensor, gate_vals: torch.Tensor,
             n_experts: int, cap: int):
    """The capacity decision of each group's (token, expert) copies, sorted
    stably by expert: (slot (G, tk) in [0, E * cap], the drop row E * cap
    for a dropped copy; keep (G, tk); the sort's permutation (G, tk) of the
    copies, copy c being token c // k's c % k-th choice; the copies'
    gates)."""
    g, tg, k = expert_ids.shape
    tk = tg * k
    dev = expert_ids.device
    e_flat = expert_ids.reshape(g, tk)
    sorted_e, order = torch.sort(e_flat, dim=-1, stable=True)
    sorted_g = torch.gather(gate_vals.reshape(g, tk), 1, order)
    experts = torch.arange(n_experts, device=dev, dtype=sorted_e.dtype)
    starts = torch.searchsorted(
        sorted_e, experts.expand(g, n_experts).contiguous(), right=False)
    pos_in_e = torch.arange(tk, device=dev) - torch.gather(starts, 1,
                                                           sorted_e)
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(sorted_e, n_experts * cap))
    return slot, keep, order, sorted_g


def moe_forward(params: Dict, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D) -> (B, S, D), aux dict (load_balance, router_z,
    drop_fraction)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    # under a mesh, at least one group a data-parallel rank
    preferred = shard_ctx.dp_size() if shard_ctx.active() else GROUPS
    g = _pick_groups(t, max(preferred, GROUPS))
    tg = t // g
    dt = x.dtype
    xg = shard_ctx.constrain(x.reshape(g, tg, d), "hidden")

    logits, probs, gate_vals, expert_ids = route(params["router"], xg, top_k)
    aux = moe_aux_losses(logits, probs, expert_ids, e)
    cap = capacity(tg, top_k, e, capacity_factor)
    slot, keep, order, sorted_g = dispatch(expert_ids, gate_vals, e, cap)

    # scatter the kept copies into their slots; every drop lands on the
    # last row, which is cut off.  The rows come from each token repeated
    # k times in copy order, permuted by the sort (one read of each), so
    # their gradient sums a token's k copies by a reduction
    copies = xg[:, :, None].expand(g, tg, top_k, d).reshape(g, tg * top_k, d)
    rows = torch.gather(copies, 1, order[..., None].expand(-1, -1, d))
    buf = xg.new_zeros((g, e * cap + 1, d)).scatter(
        1, slot[..., None].expand(-1, -1, d), rows)
    # (E, G * cap, D): one matmul per expert weight over the expert axis
    xe = shard_ctx.constrain(buf[:, :-1].reshape(g, e, cap, d),
                             "moe_experts").transpose(0, 1).reshape(
        e, g * cap, d)
    gate = F.silu(xe @ params["w_gate"].to(dt))
    up = xe @ params["w_up"].to(dt)
    he = (gate * up) @ params["w_down"].to(dt)
    he = shard_ctx.constrain(he.reshape(e, g, cap, d).transpose(0, 1),
                             "moe_experts").reshape(g, e * cap, d)

    out_rows = torch.cat([he, he.new_zeros((g, 1, d))], dim=1)
    contrib = torch.gather(out_rows, 1, slot[..., None].expand(-1, -1, d)) \
        * (sorted_g * keep).to(dt)[..., None]
    # segment_sum over the tokens: each token's k copies, in ascending
    # sorted position (= ascending expert id), added onto zero one at a time
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(tg * top_k, device=x.device).expand(g, -1))
    pos = pos.reshape(g, tg, top_k).sort(dim=-1).values
    mine = torch.gather(contrib, 1,
                        pos.reshape(g, -1, 1).expand(-1, -1, d)
                        ).reshape(g, tg, top_k, d)
    y = x.new_zeros((g, tg, d))
    for j in range(top_k):
        y = y + mine[:, :, j]
    y_flat = shard_ctx.constrain(y, "hidden").reshape(t, d)

    if "shared" in params:
        y_flat = y_flat + swiglu_forward(params["shared"], x.reshape(t, d))
    if "dense_residual" in params:
        y_flat = y_flat + swiglu_forward(params["dense_residual"],
                                         x.reshape(t, d))

    aux["drop_fraction"] = 1.0 - keep.float().mean()
    return y_flat.reshape(b, s, d), aux
