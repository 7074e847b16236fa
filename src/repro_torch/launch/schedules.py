"""Re-planning of the adaptive wire (port of ``repro/launch/schedules.py``,
``replan_widths`` and ``replan_grouped`` only).

The rest of the reference module is the split pipeline's schedules
(lockstep GPipe, the boundary probe: ROADMAP queue M, item M6) and the
hub's (``build_hub_step``, ``build_async_update``: item M9).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import entropy as entropy_mod


def replan_widths(ema_state: Dict, budget_bytes: float, *, n_groups: int,
                  scalars_per_channel: int,
                  min_bits: int = 1) -> Tuple[int, ...]:
    """EMA entropy readout -> greedy allocation over contiguous groups.
    ``budget_bytes`` budgets the code bytes of one shipment (the scale side
    information is the same for every plan of one group count)."""
    ent = entropy_mod.entropy_ema_bits(ema_state)
    return entropy_mod.allocate_bits(
        ent, budget_bytes, group_size=ent.shape[0] // n_groups,
        scalars_per_channel=scalars_per_channel, min_bits=min_bits)


def replan_grouped(ema_state: Dict, budget_bytes: float, *, n_groups: int,
                   scalars_per_channel: int, min_bits: int = 1
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Sorted-grouping re-plan: ``(channel_perm, group_widths)``."""
    ent = entropy_mod.entropy_ema_bits(ema_state)
    return entropy_mod.plan_grouped(
        ent, budget_bytes, group_size=ent.shape[0] // n_groups,
        scalars_per_channel=scalars_per_channel, min_bits=min_bits)
