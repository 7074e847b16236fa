"""The analytic half of the roofline (port of
``repro/launch/roofline.py:25-124`` and of
``benchmarks/roofline.py::weight_bytes_rows``): parameter counts,
serve-time weight bytes and model FLOPs, from the config alone.

The reference's ``derive_roofline`` reads the dry-run's XLA cost
artifacts (HLO FLOPs, bytes and collective bytes per device) and divides
them by a TPU's peaks; both the artifacts and the peaks are XLA- and
TPU-only, so it has no twin here.  Where the port needs a peak it uses the
H100's, below: the one copy that ``chip_smoke.py`` imports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.mamba2 import dims as mamba_dims

# NVIDIA H100 SXM, data sheet: dense bf16 tensor-core rate and HBM3 rate at
# the full 700 W power limit; NVLink 4 is 900 GB/s both ways, 450 GB/s in
# one direction, which is what one link of the split wire carries
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
NVLINK_BYTES_PER_S = 450e9

#: the archs of ``weight_bytes_rows``, as the reference's table
WEIGHT_BYTES_ARCHS = ("tinyllava", "llama3_2_3b", "granite_3_8b")


@dataclasses.dataclass(frozen=True)
class StepShape:
    """What ``model_flops`` reads of a step: ``kind`` is ``train``,
    ``prefill`` or ``decode``; a decode step processes one token a
    sequence."""

    kind: str
    batch: int
    seq_len: int


def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Analytic parameter counts (total, active, embedding,
    non_embedding_total).  Norms, the vision connector and the split codec
    are left out, as in the reference."""
    d = cfg.d_model
    embed = cfg.vocab_size * d * (cfg.n_codebooks or 1)
    head = d * cfg.vocab_size * (cfg.n_codebooks or 1)

    def attn_params() -> float:
        if cfg.attn_type == "mla":
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            p = cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim +
                                                  cfg.v_head_dim)
            p += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            if cfg.q_lora_rank:
                p += d * cfg.q_lora_rank + \
                    cfg.q_lora_rank * cfg.n_heads * qk
            else:
                p += d * cfg.n_heads * qk
            p += cfg.n_heads * cfg.v_head_dim * d
            return p
        hd = cfg.head_dim
        return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)

    def swiglu(f):
        return 3 * d * f

    total = 0.0
    active = 0.0
    for t in cfg.block_pattern():
        if t == "dense":
            p = attn_params() + swiglu(cfg.d_ff)
            total += p
            active += p
        elif t == "moe":
            a = attn_params()
            expert = swiglu(cfg.moe_d_ff or cfg.d_ff)
            shared = swiglu(cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
                            ) if cfg.n_shared_experts else 0
            dense_res = swiglu(cfg.d_ff) if cfg.dense_residual else 0
            total += a + cfg.n_experts * expert + shared + dense_res
            active += a + cfg.moe_top_k * expert + shared + dense_res
        elif t == "mamba2":
            d_inner, nheads, conv_dim = mamba_dims(
                d, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state)
            p = d * (2 * d_inner + 2 * cfg.ssm_state + nheads) + \
                4 * conv_dim + d_inner * d + d_inner
            total += p
            active += p
        elif t == "rwkv6":
            p = 5 * d * d + d * cfg.d_ff * 2 + d * d  # tmix + cmix
            total += p
            active += p
        elif t == "shared_attn":
            # parameters shared across occurrences: counted once in total,
            # every occurrence in active (they all execute)
            p = 2 * d * d + attn_params() + swiglu(cfg.d_ff)
            active += p
    if "shared_attn" in cfg.block_pattern():
        total += 2 * d * d + attn_params() + swiglu(cfg.d_ff)
    return dict(total=total + embed + head, active=active + head,
                embedding=embed, non_embedding_total=total + head)


def weight_stream_bits(bits: int, group: int) -> float:
    """Serve-time bits a weight element streams from memory in a packed
    store: ``bits`` code bits plus the fp16 scale and minimum of every
    ``group`` elements (``wq``'s grouped-affine layout).  16 or more is the
    dense baseline, with no side information."""
    if bits >= 16:
        return float(bits)
    return bits + 2 * 16.0 / group


def decode_weight_bytes(cfg: ArchConfig, bits: int = 16,
                        group: int = 128) -> float:
    """Weight bytes one decode tick reads (batch-free): the whole
    non-embedding stack once, its blocks at ``weight_stream_bits`` and the
    head at 2 bytes an element.  The memory floor of serving, and what
    ``wq`` shrinks."""
    counts = param_counts(cfg)
    blocks = counts["non_embedding_total"] - cfg.d_model * cfg.vocab_size * \
        (cfg.n_codebooks or 1)
    head = counts["non_embedding_total"] - blocks
    return blocks * weight_stream_bits(bits, group) / 8.0 + head * 2.0


def model_flops(cfg: ArchConfig, shape: StepShape) -> float:
    """6 N_active D for a training step (forward and backward), 2 N_active
    D for a prefill or decode step, D the tokens it processes."""
    active = param_counts(cfg)["active"]
    if shape.kind == "decode":
        return 2.0 * active * shape.batch  # one token a sequence
    tokens = shape.batch * shape.seq_len
    return (6.0 if shape.kind == "train" else 2.0) * active * tokens


def weight_bytes_rows() -> Dict[str, Dict[str, float]]:
    """Per arch, the dense bf16 weight bytes of a decode tick and the int4 /
    int3 (group 128) packed bytes with their cut ratios: the table of the
    reference's ``benchmarks/roofline.py::weight_bytes_rows``."""
    from repro_torch.configs import get_config

    table = {}
    for arch in WEIGHT_BYTES_ARCHS:
        cfg = get_config(arch)
        dense = decode_weight_bytes(cfg, bits=16)
        row = {"bf16": dense}
        for bits in (4, 3):
            packed = decode_weight_bytes(cfg, bits=bits, group=128)
            row[f"int{bits}"] = packed
            row[f"int{bits}_ratio"] = dense / packed
        table[arch] = row
    return table
