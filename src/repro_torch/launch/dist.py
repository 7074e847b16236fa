"""Process groups, device meshes and rank launching: the port's
counterpart of ``jax.make_mesh`` and of the launcher's process handling.

One process is one rank.  The group's backend is NCCL for CUDA ranks and
gloo for CPU ranks (``backend=`` overrides it: two processes that share
one card link over gloo, which NCCL refuses).  Ranks rendezvous through a
file store in a temporary directory, so no fixed port can collide with
another run, and the group has an explicit ``timeout``, so a send that
finds no receiver fails instead of hanging.

``spawn(fn, world)`` runs ``fn(rank, world, *args)`` in ``world`` new
processes.  ``fn`` is a module-level function of ``repro_torch`` (ranks
import it by name, never from a test file or a script).  Each rank's
return value and its kernel launch counts come back to the caller; a rank
that raises or exits non-zero makes ``spawn`` raise with its traceback.
Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) ``spawn`` joins the
existing world instead and runs ``fn`` on this process's rank.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 120.0  # seconds a collective or a receive may wait
_SRC = Path(__file__).resolve().parents[2]  # the directory holding the package


def _backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(rank: int, world: int, *, device: str = "cpu",
         backend: Optional[str] = None, store: Optional[str] = None,
         timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join (or create) the default process group as ``rank`` of
    ``world``: through the file store at ``store``, or from the
    environment ``torchrun`` sets when ``store`` is None.  A CUDA rank
    binds to card ``rank % cards``."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = dict(backend=backend or _backend(device), rank=rank,
              world_size=world,
              timeout=datetime.timedelta(seconds=timeout))
    if store is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.FileStore(store, world), **kw)


def from_env() -> Optional[Tuple[int, int]]:
    """(rank, world) of a ``torchrun`` world, or None outside one."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the default
    group's ranks (row-major).  A CUDA mesh needs a card for every rank:
    it raises rather than put two ranks on one card, shrink the mesh or
    move to the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    dev = torch.device(device).type
    if dev == "cuda":
        check_cards(n)
    if dist.is_initialized() and dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} over a world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(names))


def check_cards(ranks: int) -> None:
    """Raise unless this machine has a card for each of ``ranks`` CUDA
    ranks (NCCL takes one card a rank)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if ranks > cards:
        raise RuntimeError(f"{ranks} CUDA ranks need as many cards, this "
                           f"machine has {cards}")


def parse_shape(text: str) -> Tuple[int, ...]:
    """``"2x2"`` -> (2, 2)."""
    try:
        shape = tuple(int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad shape {text!r}: expected e.g. 2x2") from None
    if not shape or any(v < 1 for v in shape):
        raise ValueError(f"bad shape {text!r}")
    return shape


def _fn_name(fn: Callable) -> str:
    mod, qual = fn.__module__, fn.__qualname__
    if not mod.startswith("repro_torch.") or "<" in qual or "." in qual:
        raise ValueError("spawn runs module-level functions of repro_torch, "
                         f"got {mod}.{qual}")
    return f"{mod}:{qual}"


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import build
    return dict(build.launches)


def spawn(fn: Callable, world: int, *args, device: str = "cpu",
          backend: Optional[str] = None, timeout: float = DEFAULT_TIMEOUT,
          threads: Optional[int] = 1) -> List[Dict[str, Any]]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, one process
    each, and return ``[{"result": ..., "launches": {...}}]`` in rank
    order.  ``timeout`` bounds each collective, and 4 x ``timeout`` the
    whole run: past it every rank is killed and ``spawn`` raises.  ``threads`` pins each rank's torch thread pool
    (None leaves it).  ``args`` cross by pickle: keep them small (numpy
    arrays, configs), and let ranks build their own tensors."""
    name = _fn_name(fn)
    joined = from_env()
    if joined is not None:
        rank, size = joined
        if size != world:
            raise ValueError(f"torchrun world of {size}, asked for {world}")
        if not dist.is_initialized():
            init(rank, world, device=device, backend=backend,
                 timeout=timeout)
        out = {"result": fn(rank, world, *args),
               "launches": _launch_counts()}
        gathered: List[Any] = [None] * world
        dist.all_gather_object(gathered, out)
        return gathered
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        tmp = Path(tmp)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump(dict(fn=name, args=args, world=world, device=device,
                             backend=backend, timeout=timeout,
                             threads=threads, store=str(tmp / "store")), f)
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(_SRC)] + [p for p in child_env.get("PYTHONPATH", "")
                           .split(os.pathsep) if p])
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            child_env.pop(k, None)
        logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dist", str(tmp),
             str(r)], env=child_env, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            failed = _wait(procs, time.monotonic() + 4 * timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(log.read())
            log.close()
        if failed is not None:
            r, why = _first_failure(tmp, world, failed)
            raise RuntimeError(
                f"rank {r} of {world} ({name}) {why}; its output:\n"
                f"{text[r][-6000:]}")
        out = []
        for r in range(world):
            with open(tmp / f"result{r}.pkl", "rb") as f:
                res = pickle.load(f)
            res["log"] = text[r]
            out.append(res)
        return out


def _wait(procs, until: float) -> Optional[Tuple[int, str]]:
    """Wait for every process; the first failure (rank, why), or None."""
    while True:
        done = True
        for r, p in enumerate(procs):
            rc = p.poll()
            if rc is None:
                done = False
            elif rc != 0:
                return r, f"exited with code {rc}"
        if done:
            return None
        if time.monotonic() > until:
            alive = [r for r, p in enumerate(procs) if p.poll() is None]
            return alive[0], "ran past the deadline"
        time.sleep(0.05)


def _first_failure(tmp: Path, world: int, seen: Tuple[int, str]
                   ) -> Tuple[int, str]:
    """The rank that raised first (its error file's time), else ``seen``:
    a peer of a failed rank fails too once its link closes."""
    stamps = []
    for r in range(world):
        path = tmp / f"error{r}"
        if path.exists():
            stamps.append((float(path.read_text()), r))
    if not stamps:
        return seen
    r = min(stamps)[1]
    return r, "raised first" if r != seen[0] else seen[1]


def _rank_main(job_dir: str, rank: int) -> None:
    job_dir = Path(job_dir)
    with open(job_dir / "job.pkl", "rb") as f:
        job = pickle.load(f)
    if job["threads"]:
        torch.set_num_threads(job["threads"])
    mod, qual = job["fn"].split(":")
    fn = getattr(importlib.import_module(mod), qual)
    init(rank, job["world"], device=job["device"], backend=job["backend"],
         store=job["store"], timeout=job["timeout"])
    try:
        result = fn(rank, job["world"], *job["args"])
        out = {"result": result, "launches": _launch_counts()}
        with open(job_dir / f"result{rank}.pkl.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(job_dir / f"result{rank}.pkl.tmp",
                   job_dir / f"result{rank}.pkl")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        _rank_main(argv[0], int(argv[1]))
    except BaseException:
        Path(argv[0], f"error{argv[1]}").write_text(repr(time.time()))
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # skip the group's teardown: a peer may be gone
    return 0


if __name__ == "__main__":
    sys.exit(main())
