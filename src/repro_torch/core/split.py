"""Split-learning boundary: the in-graph compressor and the real wire
(port of ``repro/core/split.py``, lines 31-133, 140-554).

``compressor_roundtrip`` is the paper's Figure-2 path with the wire
replaced by identity: learnable linear encoder, the quantizer's roundtrip
with the straight-through estimator (RD-FSQ adds its commitment loss),
learnable linear decoder.  Any registered method serves, through its plain
roundtrip; no kernel runs in-graph.  ``wire_payload`` is the client's
wire form for byte accounting and ``analytic_bits_per_scalar`` the
Table-2 closed forms.

The real wire: ``quantized_ship`` encodes an activation with the link's
codec (on CUDA the fused kernels, K4 / K5 or K10 / K11), hands the packed
payload across a :class:`Transport` and decodes it on the receiving side;
its backward returns the cotangent over the reverse link, raw at its own
dtype (the paper's scope) or through ``bwd_quant``.  Where the reference
``ppermute``s across the ``pod`` mesh axis of one SPMD program, the port's
stages share one process and one device, and the transport is an
in-process send that counts every byte it carries.  ``WireLink`` owns one
directed cut with its shape-only byte accounting; ``HubConfig`` describes
the many-client hub's star of links (client ``c`` -> the server stage).
A SplitLoRA hub returns each client's adapter gradient over its link
(``WireLink.grad_trip`` -> ``grad_return_trip``): every leaf through
``grad_quant``, up to the server and back, once a step.

The async hub's pieces: per-client wire calibration states
(``init_wire_calib``, ``update_wire_calib``, ``calib_scale_error``) and
``quantize_cotangent``, the in-graph backward wire of a scheduler whose
client and server halves share one graph: an identity forward whose
cotangent crosses ``encode`` -> ``decode`` (on CUDA K4 / K5 or K10 / K11).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import quantizers
from repro_torch.core.payload import CommPayload, GroupedPayload
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.quantizers.topk import budget as topk_budget
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Where and how the model is cut; the reference's fields and
    defaults.  ``n_stages`` / ``stage_quants`` describe the pipeline
    topology (``launch/split_pipeline.py``): ``n_stages`` equal partitions
    give ``n_stages - 1`` quantized cuts, ``stage_quants`` optionally one
    compressor per cut (empty = ``quant`` everywhere).  The in-graph
    single cut (``cut_layer`` + ``compressor_roundtrip``) reads neither."""

    cut_layer: int = -1  # boundary index into the block stack; -1 = L // 2
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    learnable_codec: bool = True  # Figure-2 linear encoder/decoder
    enabled: bool = True
    n_stages: int = 2
    stage_quants: Tuple[QuantConfig, ...] = ()

    def resolve_cut(self, n_layers: int) -> int:
        cut = self.cut_layer if self.cut_layer >= 0 else n_layers // 2
        return min(max(cut, 0), n_layers)

    def resolve_stage_quants(self) -> Tuple[QuantConfig, ...]:
        """One QuantConfig per pipeline cut (length ``n_stages - 1``)."""
        n_cuts = self.n_stages - 1
        if not self.stage_quants:
            return (self.quant,) * n_cuts
        if len(self.stage_quants) != n_cuts:
            raise ValueError(
                f"stage_quants has {len(self.stage_quants)} entries for "
                f"{n_cuts} cuts ({self.n_stages} stages)")
        return tuple(self.stage_quants)

    def with_plans(self, plans: Tuple[Tuple[int, ...], ...]
                   ) -> "SplitConfig":
        """The same topology carrying new per-cut allocation plans:
        ``plans[c]`` becomes cut c's ``group_widths`` (empty reverts that
        cut to its static width)."""
        quants = self.resolve_stage_quants()
        if len(plans) != len(quants):
            raise ValueError(f"{len(plans)} plans for {len(quants)} cuts")
        return dataclasses.replace(self, stage_quants=tuple(
            dataclasses.replace(q, group_widths=tuple(p))
            for q, p in zip(quants, plans)))


def client_encode_pre(params: Optional[Dict], cfg: SplitConfig,
                      x: torch.Tensor) -> torch.Tensor:
    if cfg.learnable_codec and params is not None:
        return x @ params["enc_w"].to(x.dtype) + params["enc_b"].to(x.dtype)
    return x


def server_decode_post(params: Optional[Dict], cfg: SplitConfig,
                       x_hat: torch.Tensor) -> torch.Tensor:
    if cfg.learnable_codec and params is not None:
        return (x_hat @ params["dec_w"].to(x_hat.dtype)
                + params["dec_b"].to(x_hat.dtype))
    return x_hat


def compressor_roundtrip(params: Optional[Dict], cfg: SplitConfig,
                         x: torch.Tensor,
                         rng: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (server-side feature, commitment loss).  ``rng`` feeds the
    randomized quantizer (Top-K); the others ignore it."""
    if not cfg.enabled or cfg.quant.method == "none":
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = client_encode_pre(params, cfg, x)
    h_hat, commit = quantizers.roundtrip(cfg.quant, h, rng)
    return server_decode_post(params, cfg, h_hat), commit


# ---------------------------------------------------------------------------
# the real wire
# ---------------------------------------------------------------------------

_WIRE_INT = {2: torch.uint16, 4: torch.uint32, 8: torch.uint64}

Link = Tuple[int, int]  # (source stage, destination stage)


class Transport:
    """The in-process send between stages that share a process and a
    device: the counterpart of the reference's ``ppermute``.

    ``send`` hands a tensor to the receiving stage as a fresh tensor (never
    an alias of the sender's) and counts its bytes on the ``(src, dst)``
    link: ``bytes[link]`` in all and ``payloads[link]`` payloads, a payload
    being one ``send_payload`` or one raw ``send`` of a cotangent.
    """

    def __init__(self):
        self.bytes: Dict[Link, int] = collections.Counter()
        self.payloads: Dict[Link, int] = collections.Counter()

    def _send_leaf(self, a: torch.Tensor, link: Link) -> torch.Tensor:
        """One leaf at exactly its wire width: a float leaf crosses viewed
        as the unsigned integer of its width, and is viewed back after, so
        the bytes counted are the bytes of the payload's own dtype."""
        self.bytes[link] += a.numel() * a.element_size()
        if a.is_floating_point():
            wire = a.view(_WIRE_INT[a.element_size()]).clone()
            return wire.view(a.dtype)
        return a.clone()

    def send(self, a: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """One raw tensor across ``src -> dst``."""
        self.payloads[(src, dst)] += 1
        return self._send_leaf(a, (src, dst))

    def send_payload(self, payload, src: int, dst: int):
        """Every array of a ``CommPayload`` / ``GroupedPayload`` across
        ``src -> dst``; ``meta`` is the session handshake and is not
        counted, as ``wire_bytes`` does not count it."""
        link = (src, dst)
        self.payloads[link] += 1

        def one(p: CommPayload) -> CommPayload:
            return CommPayload(
                data=self._send_leaf(p.data, link),
                scales=None if p.scales is None
                else self._send_leaf(p.scales, link),
                aux={k: self._send_leaf(v, link) for k, v in p.aux.items()},
                meta=dict(p.meta))

        if isinstance(payload, GroupedPayload):
            return GroupedPayload(
                groups=tuple(one(g) for g in payload.groups),
                scale_meta=None if payload.scale_meta is None
                else self._send_leaf(payload.scale_meta, link),
                meta=dict(payload.meta))
        return one(payload)


class _QuantizedShip(torch.autograd.Function):
    """Forward: encode, send ``src -> dst``, decode.  Backward: the
    cotangent returns ``dst -> src``, raw or through ``bwd_cfg``."""

    @staticmethod
    def forward(ctx, x, cfg, transport, link, bwd_cfg):
        ctx.transport, ctx.link, ctx.bwd_cfg = transport, link, bwd_cfg
        payload = quantizers.encode(cfg, x)
        shipped = transport.send_payload(payload, *link)
        return quantizers.decode(cfg, shipped).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        src, dst = ctx.link
        if ctx.bwd_cfg is None:
            # the paper's scope: the cotangent returns uncompressed, at its
            # own dtype
            return ctx.transport.send(g, dst, src), None, None, None, None
        payload = quantizers.encode(ctx.bwd_cfg, g)
        shipped = ctx.transport.send_payload(payload, dst, src)
        g_hat = quantizers.decode(ctx.bwd_cfg, shipped).to(g.dtype)
        return g_hat, None, None, None, None


def quantized_ship(cfg: QuantConfig, x: torch.Tensor, transport: Transport,
                   perm: Tuple[Link, ...],
                   bwd_cfg: Optional[QuantConfig] = None) -> torch.Tensor:
    """Quantize -> pack -> send over ``transport`` -> decode; the gradient
    crosses back as the reference's custom VJP sends it.  ``perm`` is the
    reference's permutation; in one process an activation has one source
    stage, so it holds one ``(src, dst)`` pair."""
    if len(perm) != 1:
        raise ValueError("the in-process transport ships one link's "
                         f"activation at a time, got perm {perm}")
    return _QuantizedShip.apply(x, cfg, transport, tuple(perm[0]), bwd_cfg)


def payload_bytes(q: QuantConfig, shape, dtype) -> int:
    """Wire bytes of ``encode(q, x)`` for an ``x`` of this shape and dtype,
    from shapes alone: the codec runs on a meta tensor.  Top-K draws its
    random picks from a generator that has no meta device, so it encodes
    zeros on the CPU; its payload's size does not depend on the data."""
    if q.method == "topk":
        x = torch.zeros(shape, dtype=dtype)
        return quantizers.encode(
            q, x, torch.Generator().manual_seed(0)).wire_bytes()
    return quantizers.encode(
        q, torch.empty(shape, dtype=dtype, device="meta")).wire_bytes()


@dataclasses.dataclass(frozen=True)
class WireLink:
    """One directed quantized edge of a split topology: the forward
    ``QuantConfig``, the optional backward (cotangent) quant, and the
    per-link byte accounting.  ``src`` / ``dst`` are stage indices;
    ``client`` tags hub links (``HubConfig.links``); ``grad_quant`` is the
    codec of a SplitLoRA hub's adapter-gradient return (None = raw), the
    cotangent (``bwd_quant``) being unchanged.  Each link is counted once,
    on the stages that run it."""

    src: int
    dst: int
    quant: QuantConfig
    bwd_quant: Optional[QuantConfig] = None
    client: Optional[int] = None
    grad_quant: Optional[QuantConfig] = None

    @property
    def perm(self) -> Tuple[Link, ...]:
        return ((self.src, self.dst),)

    @property
    def plan(self) -> Tuple[int, ...]:
        """The link's bit-allocation plan (empty = static single width)."""
        return tuple(self.quant.group_widths)

    def with_plan(self, widths: Tuple[int, ...],
                  perm: Tuple[int, ...] = ()) -> "WireLink":
        """The same link carrying a new allocation plan (and sorted
        grouping ``perm``) on its forward quant; the backward quant is
        untouched."""
        return dataclasses.replace(
            self, quant=dataclasses.replace(self.quant,
                                            group_widths=tuple(widths),
                                            channel_perm=tuple(perm)))

    def ship(self, x: torch.Tensor, transport: Transport) -> torch.Tensor:
        """The real wire: encode -> send src -> dst -> decode."""
        return quantized_ship(self.quant, x, transport, self.perm,
                              self.bwd_quant)

    def fwd_wire_bytes(self, shape, dtype) -> int:
        """Forward payload bytes for one activation of ``shape`` /
        ``dtype``, from shapes alone."""
        return payload_bytes(self.quant, tuple(shape), dtype)

    def bwd_wire_bytes(self, shape, dtype) -> int:
        """Backward (cotangent) bytes: the packed payload when
        ``bwd_quant`` is set, else the raw activation bytes."""
        if self.bwd_quant is None:
            return math.prod(shape) * torch.empty(
                (), dtype=dtype).element_size()
        return payload_bytes(self.bwd_quant, tuple(shape), dtype)

    def grad_wire_bytes(self, grad_tree) -> int:
        """Bytes of ONE direction of the adapter-gradient return: the
        ``grad_quant`` payloads of ``grad_tree`` (shapes alone; ``meta``
        leaves do).  The trip crosses the link twice, up and back, once a
        step."""
        return tree_payload_bytes(self.grad_quant, grad_tree)

    def grad_trip(self, grad_tree, transport: Transport):
        """The adapter-gradient tree across this link, up and back
        (:func:`grad_return_trip`): the gradient the optimizer applies."""
        return grad_return_trip(self.grad_quant, grad_tree, transport,
                                self.perm)


def tree_payload_bytes(q: Optional[QuantConfig], tree) -> int:
    """Wire bytes of a quantized tree (one payload per leaf), from shapes
    alone; ``q`` None (or identity) counts each leaf raw at its dtype.
    Leaves are tensors (any device, ``meta`` included)."""
    total = 0
    for leaf in tree_leaves(tree):
        if q is None or q.method == "identity":
            total += leaf.numel() * leaf.element_size()
        else:
            total += payload_bytes(q, tuple(leaf.shape), leaf.dtype)
    return int(total)


def grad_return_trip(q: Optional[QuantConfig], tree, transport: Transport,
                     perm: Tuple[Link, ...]):
    """SplitLoRA's gradient return: each leaf of an adapter-gradient tree
    is encoded with ``q``, its payload sent ``src -> dst`` (to the
    server), the payload the server accepted sent back ``dst -> src``, and
    decoded to the leaf's dtype.  ``q`` None (or identity) sends the raw
    leaf up and back.  Each direction counts exactly
    ``tree_payload_bytes(q, tree)`` on ``transport``.  The codec takes its
    default backend: an 8-bit ``stats_axis="tensor"`` RD-FSQ, the hub's,
    is the plain flat-stream codec on any device (no kernel), as in the
    reference."""
    if len(perm) != 1:
        raise ValueError("the in-process transport returns one link's "
                         f"gradient at a time, got perm {perm}")
    src, dst = perm[0]

    def one(leaf):
        if q is None or q.method == "identity":
            return transport.send(transport.send(leaf, src, dst), dst, src)
        up = transport.send_payload(quantizers.encode(q, leaf), src, dst)
        back = transport.send_payload(up, dst, src)
        return quantizers.decode(q, back).to(leaf.dtype)

    return tree_map(one, tree)


def pipeline_links(split: SplitConfig,
                   bwd_quant: Optional[QuantConfig] = None
                   ) -> Tuple[WireLink, ...]:
    """Chain topology: cut c connects stage c -> c + 1."""
    return tuple(WireLink(src=c, dst=c + 1, quant=q, bwd_quant=bwd_quant)
                 for c, q in enumerate(split.resolve_stage_quants()))


@dataclasses.dataclass(frozen=True)
class HubConfig:
    """Many-client split-learning hub: N clients sharing one server stage.

    Stages 0 .. N-1 are the clients' bottom halves (embed + L/2 blocks),
    stage N the shared server half (L/2 blocks + head), batched over the
    clients' arrivals.  ``client_quants`` optionally gives each client its
    own wire codec (empty = ``quant`` everywhere); ``bwd_quant`` is the
    cotangent's codec on every link (None = raw).  ``tick_rates`` drives
    the async scheduler (``launch/schedules.py::build_async_update``):
    client c produces a microbatch every ``tick_rates[c]`` global ticks
    (empty = all 1).
    ``grad_quant`` is the adapter-gradient return's codec, read only by a
    SplitLoRA hub (``lora_rank > 0``; None = raw)."""

    n_clients: int = 1
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    client_quants: Tuple[QuantConfig, ...] = ()
    bwd_quant: Optional[QuantConfig] = None
    tick_rates: Tuple[int, ...] = ()
    grad_quant: Optional[QuantConfig] = None

    @property
    def server_stage(self) -> int:
        """Stage index of the shared server."""
        return self.n_clients

    def resolve_client_quants(self) -> Tuple[QuantConfig, ...]:
        if not self.client_quants:
            return (self.quant,) * self.n_clients
        if len(self.client_quants) != self.n_clients:
            raise ValueError(
                f"client_quants has {len(self.client_quants)} entries for "
                f"{self.n_clients} clients")
        return tuple(self.client_quants)

    def resolve_tick_rates(self) -> Tuple[int, ...]:
        if not self.tick_rates:
            return (1,) * self.n_clients
        if len(self.tick_rates) != self.n_clients:
            raise ValueError(
                f"tick_rates has {len(self.tick_rates)} entries for "
                f"{self.n_clients} clients")
        if any(r < 1 for r in self.tick_rates):
            raise ValueError(f"tick rates must be >= 1: {self.tick_rates}")
        return tuple(self.tick_rates)

    def links(self) -> Tuple[WireLink, ...]:
        """Star topology: client c -> server, one link per client."""
        return tuple(WireLink(src=c, dst=self.server_stage, quant=q,
                              bwd_quant=self.bwd_quant, client=c,
                              grad_quant=self.grad_quant)
                     for c, q in enumerate(self.resolve_client_quants()))

    def with_plans(self, plans: Tuple[Tuple[int, ...], ...]) -> "HubConfig":
        """The same hub carrying new per-client allocation plans:
        ``plans[c]`` becomes client c's ``group_widths`` (empty reverts
        that client to its static width)."""
        quants = self.resolve_client_quants()
        if len(plans) != len(quants):
            raise ValueError(
                f"{len(plans)} plans for {len(quants)} clients")
        return dataclasses.replace(self, client_quants=tuple(
            dataclasses.replace(q, group_widths=tuple(p))
            for q, p in zip(quants, plans)))


def group_links(links: Tuple[WireLink, ...]
                ) -> Tuple[Tuple[QuantConfig, Optional[QuantConfig],
                                 Tuple[WireLink, ...]], ...]:
    """Links grouped by identical (quant, bwd_quant), in first-seen
    order: the reference emits one collective per group.  The in-process
    schedules ship link by link and do not group (the reference's hub
    cannot either: its links share a destination)."""
    groups: list = []
    for link in links:
        for i, (q, bq, ls) in enumerate(groups):
            if q == link.quant and bq == link.bwd_quant:
                groups[i] = (q, bq, ls + (link,))
                break
        else:
            groups.append((link.quant, link.bwd_quant, (link,)))
    return tuple(groups)


# ---------------------------------------------------------------------------
# per-client wire calibration state
# ---------------------------------------------------------------------------

_CALIB_KEYS = ("mean", "std", "lo", "hi")


def init_wire_calib() -> Dict[str, torch.Tensor]:
    """Per-link codec calibration state: EMAs of the activation statistics
    the wire codecs derive their scales from (RD-FSQ: mu / sigma and the
    clipped min / max; NF-b: the per-block absmax is bounded by the same
    range), as 0-dim fp32 tensors.  One state per (link, client); the hub
    keeps them isolated, so one client's distribution never leaks into
    another's codec."""
    return {k: torch.zeros((), dtype=torch.float32)
            for k in _CALIB_KEYS + ("count",)}


@torch.no_grad()
def update_wire_calib(calib: Dict[str, torch.Tensor], x: torch.Tensor,
                      decay: float = 0.9) -> Dict[str, torch.Tensor]:
    """EMA-update a calibration state with one activation batch.  The first
    update (``count == 0``) adopts the batch statistics outright, so a
    fresh state is usable at once; later ones blend with ``decay``.  The
    std is the population std, as ``jnp.std``'s."""
    xf = x.float()
    batch = dict(mean=xf.mean(), std=xf.std(unbiased=False), lo=xf.min(),
                 hi=xf.max())
    count = calib["count"]
    out = {k: torch.where(count > 0.0,
                          decay * calib[k] + (1.0 - decay) * batch[k],
                          batch[k])
           for k in _CALIB_KEYS}
    out["count"] = count + 1.0
    return out


def calib_scale_error(calib: Dict[str, torch.Tensor],
                      other: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Relative distance between two calibration states' ranges: the
    isolation metric of the hub's tests."""
    span_a = calib["hi"] - calib["lo"]
    span_b = other["hi"] - other["lo"]
    return (span_a - span_b).abs() / (torch.maximum(span_a.abs(),
                                                    span_b.abs()) + 1e-8)


# ---------------------------------------------------------------------------
# the in-graph cotangent wire (the async hub's backward)
# ---------------------------------------------------------------------------

class _QuantizeCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        ctx.cfg = cfg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        if cfg is None or cfg.method == "identity":
            return g, None
        g_hat = quantizers.decode(cfg, quantizers.encode(cfg, g))
        return g_hat.to(g.dtype), None


def quantize_cotangent(cfg: Optional[QuantConfig],
                       x: torch.Tensor) -> torch.Tensor:
    """Identity forward; on the way back the cotangent crosses ``cfg``'s
    wire codec, ``encode`` -> ``decode`` with their default backend (on a
    CUDA tensor K4 / K5 or K10 / K11 where ``kernel_codecs``' rule admits
    the config, else the plain flat-stream codec).  ``cfg`` None or
    ``identity``: the cotangent passes through untouched.

    The in-graph twin of ``quantized_ship``'s ``bwd_cfg``, for schedulers
    whose client and server halves share one graph (the async hub): the
    forward activation already crossed by the STE roundtrip, and this
    makes the gradient take the quantized wire form too."""
    return _QuantizeCotangent.apply(x, cfg)


def wire_payload(cfg: SplitConfig, params: Optional[Dict], x: torch.Tensor,
                 rng: Optional[torch.Generator] = None) -> CommPayload:
    """Client-side wire form (for byte accounting)."""
    h = client_encode_pre(params, cfg, x)
    return quantizers.encode(cfg.quant, h, rng)


def analytic_bits_per_scalar(q: QuantConfig, h_dim: int) -> float:
    """Paper Table 2 closed forms; a grouped plan's rate is its mean width
    (exact: the bitstream packers charge every width its true cost)."""
    if q.method in ("fsq", "rdfsq", "nf"):
        return q.mean_bits() if q.grouped else float(q.bits)
    if q.method == "topk":
        k_det, k_rand = topk_budget(q, h_dim)
        return 16.0 * (k_det + k_rand) / h_dim
    if q.method == "identity":
        return 16.0
    raise ValueError(q.method)
