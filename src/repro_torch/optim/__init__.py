"""AdamW and learning-rate schedules (port of ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, opt_state_bytes,
                                     param_bytes)

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "opt_state_bytes", "param_bytes"]
