"""Continuous-batching serving engine over the paged KV pool (port of
``repro/serve/engine.py``).

Requests arrive at any time, are admitted into decode slots as soon as a
slot and their full page reservation are free, and retire at EOS or at
their token budget, returning their pages at once.  One ``step()`` is:
admit (+ one batched prefill of the admissions) -> one decode tick over
every active slot.  Prefill batches are bucketed: the row count and the
page count to the next power of two, padded rows being all-zero images.

Split-serve mode (``split_wire=QuantConfig(...)``): the engine runs the
connector client-side, ships its activations through the wire codec
(``quantizers.encode`` -> ``decode``: on CUDA the kernels K4 / K5), feeds
the reconstruction to the server prefill through the ``image_features``
bypass, and counts the payload bytes, padded rows included, in
``stats["wire_bytes"]``.  Any registered codec serves: the 2-bit RD-FSQ
wire (K4 / K5), NF-b (K10 / K11), or a grouped plan (``group_widths``),
which ships a mixed-width ``GroupedPayload``.

Entropy-adaptive mode (``split_wire_budget_bits``): before each shipment
the connector features advance a per-channel entropy EMA, and the wire is
re-planned (entropy-sorted channel order and per-group widths, budgeted at
that many mean code bits per scalar over ``split_plan_groups`` groups).
A changed plan replaces ``split_wire`` and is recorded in
``stats["wire_plan"]``.

SplitLoRA serving (``lora_adapters=``, ``lora_scale``): the adapters are
folded into the base weights once, at construction, before any
``weight_quant`` packing (the adapters must fold into the dense weights
before they are frozen into codes); ``merge_lora`` is ``apply_lora``'s
arithmetic, so serving merged params is token-exact against the adapter
forward, at no cost a token.

A text config (``llama3_2_3b``) takes requests of tokens alone; a vlm
config (``tinyllava``) takes an image's embeddings with each.  An audio
config raises, in the reference's words; so do configs whose blocks have
no paged form (MLA, mamba2, rwkv6), from the pools' constructor.

Weight-only quantized serving (``weight_quant="int4" | "int3" |
"int2"``): once the params are on the device, every w* matmul site of the
block stacks is replaced with a packed ``wq.PackedLinear`` store, by GPTQ
from the Hessians of a calibration batch (``wq_calib``) or else by
round-to-nearest; its matmuls run the packed dequant-matmul (K12 on
CUDA).  ``stats["weight_bytes_dense"]`` / ``["weight_bytes_packed"]``
hold the sites' bytes before and after, and ``["wq_calib_seconds"]`` /
``["wq_quantize_seconds"]`` the host time of the two passes.

Everything runs under ``torch.inference_mode()``; the KV pools are
updated in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch import wq
from repro_torch.core import entropy as entropy_mod
from repro_torch.core import quantizers
from repro_torch.core.quantizers import QuantConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import schedules
from repro_torch.models import transformer as tf
from repro_torch.models.layers.mlp import mlp_forward
from repro_torch.peft import merge_lora
from repro_torch.serve import decode as sd
from repro_torch.serve import paged
from repro_torch.serve.pool import PagePool
from repro_torch.serve.scheduler import Request, SlotScheduler

__all__ = ["ServeEngine"]


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    """Slot-based continuous-batching engine (single host, one model)."""

    def __init__(self, params: Dict, cfg: ArchConfig, *, n_slots: int,
                 page_size: int, n_pages: int,
                 window: Optional[int] = None, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 split_wire: Optional[QuantConfig] = None,
                 split_wire_budget_bits: Optional[float] = None,
                 split_plan_groups: int = 8,
                 lora_adapters=None, lora_scale: float = 1.0,
                 weight_quant: Optional[str] = None,
                 wq_group: int = 128, wq_act_order: bool = False,
                 wq_calib: Optional[Dict] = None,
                 device: DeviceLike = None):
        if cfg.modality == "audio":
            raise NotImplementedError("engine serves text/vlm configs")
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        if lora_adapters is not None:
            with torch.no_grad():
                self.params = merge_lora(
                    self.params, _to_device(lora_adapters, self.device),
                    scale=lora_scale)
        self.wq_report = None
        wq_stats = {}
        if weight_quant is not None:
            wcfg = wq.parse_weight_quant(weight_quant, group=wq_group,
                                         act_order=wq_act_order)
            hessians = None
            t0 = time.perf_counter()
            if wq_calib is not None:
                hessians = wq.collect_hessians(self.params, cfg, wq_calib,
                                               window=window)
            t1 = time.perf_counter()
            self.params, self.wq_report = wq.quantize_params(
                self.params, wcfg, hessians=hessians)
            wq_stats = dict(
                weight_bytes_dense=sum(d for d, _ in self.wq_report.values()),
                weight_bytes_packed=sum(
                    p for _, p in self.wq_report.values()),
                wq_calib_seconds=t1 - t0,
                wq_quantize_seconds=time.perf_counter() - t1)
        self.cfg = cfg
        self.page_size = page_size
        self.window = window
        self.temperature = temperature
        self.eos_id = eos_id
        self.split_wire = split_wire
        self.split_wire_budget_bits = split_wire_budget_bits
        self.split_plan_groups = split_plan_groups
        self._wire_ema = None
        if split_wire_budget_bits is not None:
            if split_wire is None:
                raise ValueError("split_wire_budget_bits needs split_wire")
            self._wire_ema = entropy_mod.init_entropy_ema(
                cfg.d_model, device=self.device)
        with torch.inference_mode():
            self.pools = paged.init_pools(cfg, n_pages, page_size,
                                          device=self.device)
        self.page_pool = PagePool(n_pages)
        self.n_image_tokens = cfg.n_image_tokens \
            if cfg.modality == "vlm" else 0
        self.scheduler = SlotScheduler(n_slots, self.page_pool, page_size,
                                       n_image_tokens=self.n_image_tokens)
        self._gen = torch.Generator().manual_seed(seed)
        self._next_rid = 0
        self.stats = dict(wire_bytes=0, prefill_batches=0, prefill_rows=0,
                          decode_ticks=0, tokens_emitted=0, admitted=0,
                          retired=0, page_table_buckets=set(),
                          prefill_seconds=0.0, decode_seconds=0.0,
                          **wq_stats)

    # -- request intake -------------------------------------------------
    def submit(self, tokens: List[int], *, max_new: int,
               image_embeds=None, arrival_time: float = 0.0) -> int:
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.cfg.modality == "vlm" and image_embeds is None:
            raise ValueError("vlm configs require image_embeds per request")
        rid = self._next_rid
        self._next_rid += 1
        self.scheduler.submit(Request(rid=rid, tokens=list(tokens),
                                      max_new=max_new,
                                      image_embeds=image_embeds,
                                      arrival_time=arrival_time))
        return rid

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    def request(self, rid: int) -> Request:
        return self.scheduler.requests[rid]

    # -- sampling -------------------------------------------------------
    def _pick(self, last_logits: torch.Tensor) -> np.ndarray:
        """(m, V) -> (m,) token ids: greedy, or temperature sampling by
        the Gumbel-max trick with the engine's own generator."""
        logits = last_logits.float().cpu()
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).numpy()
        u = torch.rand(logits.shape, generator=self._gen)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return (logits / self.temperature + gumbel).argmax(dim=-1).numpy()

    def _maybe_finish(self, req: Request, tok: int) -> None:
        if self.eos_id is not None and tok == self.eos_id:
            self.scheduler.retire(req, "eos")
        elif len(req.out) >= req.max_new:
            self.scheduler.retire(req, "length")
        if req.state == "done":
            self.stats["retired"] += 1

    # -- prefill (admission batch) --------------------------------------
    def _ship_image_features(self, image_embeds: torch.Tensor
                             ) -> torch.Tensor:
        """Client-side connector -> quantized wire -> server-side
        reconstruction, with payload byte accounting.  In adaptive mode the
        features first advance the entropy EMA and may re-plan the wire for
        this and later shipments."""
        feats = mlp_forward(self.params["connector"],
                            image_embeds.to(tf.cdtype(self.cfg)))
        if self.split_wire_budget_bits is not None:
            self._wire_ema = entropy_mod.update_entropy_ema(self._wire_ema,
                                                            feats)
            d = feats.shape[-1]
            perm, plan = schedules.replan_grouped(
                self._wire_ema,
                self.split_wire_budget_bits * feats.numel() / 8.0,
                n_groups=self.split_plan_groups,
                scalars_per_channel=feats.numel() // d)
            if (plan != self.split_wire.group_widths
                    or perm != self.split_wire.channel_perm):
                self.split_wire = dataclasses.replace(
                    self.split_wire, group_widths=plan, channel_perm=perm)
                self.stats["wire_plan"] = plan
        payload = quantizers.encode(self.split_wire, feats)
        self.stats["wire_bytes"] += payload.wire_bytes()
        return quantizers.decode(self.split_wire, payload)

    def _prefill(self, admitted: List[Request]) -> None:
        t0 = time.perf_counter()
        pg, n_img, dev = self.page_size, self.n_image_tokens, self.device
        plens = [len(r.tokens) for r in admitted]
        # bucket the prefill shape: pow2 page count, pow2 row count
        npb = paged.next_pow2(-(-(n_img + max(plens)) // pg))
        lb = npb * pg
        rows = paged.next_pow2(len(admitted))
        lp = lb - n_img  # token length such that positions cover exactly lb
        tokens = np.zeros((rows, lp), np.int64)
        for i, r in enumerate(admitted):
            tokens[i, :len(r.tokens)] = r.tokens
        batch: Dict = dict(tokens=torch.as_tensor(tokens, device=dev))
        if self.cfg.modality == "vlm":
            imgs = [torch.as_tensor(r.image_embeds, device=dev)
                    for r in admitted]
            imgs += [torch.zeros_like(imgs[0])] * (rows - len(admitted))
            imgs = torch.stack(imgs)
            if self.split_wire is not None:
                batch["image_features"] = self._ship_image_features(imgs)
            else:
                batch["image_embeds"] = imgs
        logits, caches = sd.prefill(self.params, self.cfg, batch, lb,
                                    window=self.window)
        # scatter the ring caches into each request's physical pages;
        # logical pages past a row's reservation (and the padded rows) go
        # to the trash page, right-padding is masked to pos = -1
        page_rows = np.zeros((rows, npb), np.int32)
        valid_len = np.zeros((rows,), np.int32)
        for i, r in enumerate(admitted):
            page_rows[i] = (r.pages + [0] * npb)[:npb]
            valid_len[i] = n_img + plens[i]
        paged.insert_prefill(self.pools, caches,
                             torch.as_tensor(page_rows, device=dev),
                             torch.as_tensor(valid_len, device=dev))
        # first token: the pick at each row's LAST REAL position
        last_idx = torch.as_tensor([n_img + p - 1 for p in plens],
                                   device=dev)
        toks = self._pick(logits[torch.arange(len(admitted), device=dev),
                                 last_idx])
        now = time.perf_counter()
        for r, tok in zip(admitted, toks):
            r.out.append(int(tok))
            r.prefill_time = now
            r.emit_times.append(now)
            self.stats["tokens_emitted"] += 1
            self._maybe_finish(r, int(tok))
        self.stats["prefill_batches"] += 1
        self.stats["prefill_rows"] += rows
        self.stats["admitted"] += len(admitted)
        self.stats["prefill_seconds"] += now - t0

    # -- decode tick ----------------------------------------------------
    def _decode_tick(self, active: List[Request]) -> None:
        t0 = time.perf_counter()
        pg = self.page_size
        s = self.scheduler.n_slots
        npp = paged.next_pow2(max(r.qpos // pg + 1 for r in active))
        self.stats["page_table_buckets"].add(npp)
        tokens = np.zeros((s, 1), np.int64)
        qpos = np.full((s,), -1, np.int32)
        page_table = np.full((s, npp), -1, np.int32)
        for r in active:
            tokens[r.slot, 0] = r.out[-1]
            qpos[r.slot] = r.qpos
            row = r.pages[:npp]
            page_table[r.slot, :len(row)] = row
        logits, self.pools = paged.paged_step(
            self.params, self.cfg, self.pools,
            dict(tokens=torch.as_tensor(tokens, device=self.device)),
            torch.as_tensor(qpos, device=self.device),
            torch.as_tensor(page_table, device=self.device),
            window=self.window)
        toks = self._pick(logits[:, -1])
        now = time.perf_counter()
        for r in active:
            tok = int(toks[r.slot])
            r.out.append(tok)
            r.qpos += 1
            r.emit_times.append(now)
            self.stats["tokens_emitted"] += 1
            self._maybe_finish(r, tok)
        self.stats["decode_ticks"] += 1
        self.stats["decode_seconds"] += now - t0

    # -- main loop ------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        """One engine tick: admit (+ prefill) then decode every slot."""
        admitted = self.scheduler.admit()
        if admitted:
            self._prefill(admitted)
        active = self.scheduler.active
        if active:
            self._decode_tick(active)

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request finished."""
        while not self.idle:
            before = (self.stats["tokens_emitted"],
                      len(self.scheduler.waiting))
            self.step()
            after = (self.stats["tokens_emitted"],
                     len(self.scheduler.waiting))
            if before == after:  # no progress: pool can never fit the head
                head = self.scheduler.waiting[0]
                raise RuntimeError(
                    f"request {head.rid} needs "
                    f"{self.scheduler.pages_needed(head)} pages but the "
                    f"pool only has {self.page_pool.n_pages - 1}")
        return {rid: r.out for rid, r in self.scheduler.requests.items()}
