"""Paper Table 4: communication cost of a split deployment (port of
``benchmarks/table4_comm.py``).

For each method and width, per forward transmission of tinyllava's
boundary activations (the connector's features):

* the bytes on the wire (the packed payload: the ground truth),
* pickle serialisation and deserialisation time on the host (as the
  paper), the payload copied off the device first,
* the simulated wire time on the paper's 1 Gbit/s client <-> server LAN
  and on one direction of an H100's NVLink 4 (450 GB/s, data sheet), the
  link between two cards of one host.

Reported per 100 batches, the paper's unit.  ``run_hub`` tabulates the
many-client hub's per-link bytes for 1 / 2 / 4 / 8 clients alternating
2-bit RD-FSQ and 4-bit NF (``launch/schedules.py::hub_wire_bytes``); it
returns the table and writes nothing.
"""
from __future__ import annotations

import pickle
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import HubConfig, SplitConfig, wire_payload
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import schedules
from repro_torch.launch.roofline import NVLINK_BYTES_PER_S
from repro_torch.models import transformer as tf
from repro_torch.models.layers.mlp import mlp_forward
from repro_torch.paper.common import emit
from repro_torch.train.loop import batch_to

LAN_BYTES_PER_S = 1e9 / 8  # 1 Gbit/s
BATCHES = 20
SETTINGS = (("identity", 16), ("rdfsq", 2), ("nf", 2), ("rdfsq", 3),
            ("nf", 3), ("rdfsq", 4), ("nf", 4))


@torch.no_grad()
def connector_features(cfg: ArchConfig, params: Dict, n_batches: int,
                       seed: int, device: torch.device):
    """The connector's fp32 features of ``n_batches`` batches of 8 x 32
    positions from the data pipeline."""
    pipe = make_pipeline(cfg, batch_size=8, seq_len=32, seed=seed)
    return [mlp_forward(params["connector"],
                        batch_to(next(pipe), device)["image_embeds"].float())
            for _ in range(n_batches)]


def run(cfg: Optional[ArchConfig] = None, n_batches: int = BATCHES,
        seed: int = 0, device: DeviceLike = None,
        params: Optional[Dict] = None) -> Dict:
    """The table's rows by (method, bits): ``bytes`` over the batches,
    ``mb`` and ``time_lan`` per 100 batches; ``reduction`` (2-bit RD-FSQ
    against 16 bits) and ``hub`` (``run_hub``).  ``cfg`` defaults to
    ``tinyllava.reduced()``, ``params`` to a draw from ``seed``."""
    cfg = cfg or get_config("tinyllava").reduced()
    dev = resolve_device(device)
    if params is None:
        params = tf.init_params(cfg, seed=seed, device=dev)
    scale = 100 / n_batches  # report per 100 batches
    feats = connector_features(cfg, params, n_batches, seed, dev)
    rows = {}
    for method, bits in SETTINGS:
        split = SplitConfig(quant=QuantConfig(method=method, bits=bits),
                            learnable_codec=False)
        total_bytes = 0
        ser_time = 0.0
        for h in feats:
            payload = wire_payload(split, None, h)
            # each array as its raw bytes: numpy has no bfloat16
            arrays = [a.cpu().contiguous().view(torch.uint8).numpy()
                      for a in payload.arrays()]
            t0 = time.perf_counter()
            blob = pickle.dumps(arrays, protocol=4)
            pickle.loads(blob)  # our own bytes, just written
            ser_time += time.perf_counter() - t0
            total_bytes += payload.wire_bytes()
        lan_s = total_bytes / LAN_BYTES_PER_S
        nvlink_s = total_bytes / NVLINK_BYTES_PER_S
        comm_time_lan = (ser_time + lan_s) * scale
        name = "original" if method == "identity" else method
        rows[(method, bits)] = dict(bytes=total_bytes,
                                    mb=total_bytes * scale / 2 ** 20,
                                    time_lan=comm_time_lan)
        emit(f"table4/{name}_{bits}bit", ser_time / n_batches * 1e6,
             f"amount_MB_per100={total_bytes * scale / 2 ** 20:.2f};"
             f"time_s_per100_LAN={comm_time_lan:.4f};"
             f"time_s_per100_NVLink={(ser_time + nvlink_s) * scale:.4f}")
    red = 1 - rows[("rdfsq", 2)]["mb"] / rows[("identity", 16)]["mb"]
    emit("table4/reduction_2bit_vs_16bit", 0.0,
         f"byte_reduction={red:.4f};paper_claims=0.875")
    rows["reduction"] = red
    rows["hub"] = run_hub(cfg)
    return rows


def run_hub(cfg: ArchConfig, micro_batch: int = 8, seq: int = 32,
            clients_list=(1, 2, 4, 8)) -> Dict[int, Dict]:
    """Per-link hub wire bytes against the number of clients: each
    client's link carries its own codec's payload (2-bit RD-FSQ for even
    clients, 4-bit NF for odd ones), so the server's ingress grows with the
    mix of clients, not only their count.  Shape-only accounting."""
    out = {}
    for n in clients_list:
        quants = tuple(QuantConfig(method="rdfsq", bits=2) if c % 2 == 0
                       else QuantConfig(method="nf", bits=4)
                       for c in range(n))
        hub = HubConfig(n_clients=n, client_quants=quants)
        wire = schedules.hub_wire_bytes(cfg, hub, micro_batch, seq)
        links = {f"{s}->{d}": v["fwd"]
                 for (s, d), v in sorted(wire["links"].items())}
        ingress = wire["fwd_total"]
        out[n] = dict(links=links, server_ingress_bytes_per_tick=ingress,
                      lan_s_per_tick=ingress / LAN_BYTES_PER_S)
        emit(f"table4/hub_{n}clients", 0.0,
             f"server_ingress_B_per_tick={ingress};"
             f"lan_s_per_tick={ingress / LAN_BYTES_PER_S:.6f};"
             f"links={len(links)}")
    return out
