"""Sharding rules and the activation-sharding context (port of
``repro/sharding``): specs as the reference's per-dim tuples of mesh-axis
names, DTensor placements from them (``to_placements``)."""
from repro_torch.sharding.specs import (batch_pspecs, cache_pspecs,
                                        leaf_pspec, mesh_axes, opt_pspecs,
                                        param_pspecs, state_pspecs,
                                        to_placements)

__all__ = ["batch_pspecs", "cache_pspecs", "leaf_pspec", "mesh_axes",
           "opt_pspecs", "param_pspecs", "state_pspecs", "to_placements"]
