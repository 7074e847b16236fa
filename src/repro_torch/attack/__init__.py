"""The feature-inversion attack (port of ``repro/attack``)."""
from repro_torch.attack.inversion import (attack_forward, attack_step,
                                          init_attack_params,
                                          reconstruction_loss, train_attack)

__all__ = ["attack_forward", "attack_step", "init_attack_params",
           "reconstruction_loss", "train_attack"]
