"""Parameter-efficient fine-tuning: SplitLoRA (port of ``repro/peft``)."""
from repro_torch.peft.lora import (adapter_bytes, adapter_param_count,
                                   apply_lora, init_lora_params,
                                   is_lora_site, lora_delta, lora_shapes,
                                   lora_sites, merge_lora, unmerge_lora)

__all__ = ["adapter_bytes", "adapter_param_count", "apply_lora",
           "init_lora_params", "is_lora_site", "lora_delta", "lora_shapes",
           "lora_sites", "merge_lora", "unmerge_lora"]
