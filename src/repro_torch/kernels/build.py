"""Build, load and count the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded through ``ctypes``.
The build runs at first use, one ``nvcc`` per source started together,
into ``build/repro_torch_kernels/`` at the root of the checkout; the
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

``launches`` counts, per kernel, the launches its wrapper made: a wrapper
adds one right after a launch that returned no error, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rdfsq_quantize",
           "rdfsq_dequantize", "decode", "decode_q8", "decode_paged",
           "decode_paged_q8", "nf_quantize", "nf_dequantize", "wq_matmul")
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "flash_fwd_bf16": [_P] * 8 + [_I] * 5 + [_LL] * 12 + [_I] * 4 + [_P],
    "flash_bwd_dq_bf16": [_P] * 10 + [_I] * 5 + [_LL] * 15 + [_I] * 7
    + [_P],
    "flash_bwd_dkv_bf16": [_P] * 11 + [_I] * 5 + [_LL] * 18 + [_I] * 7
    + [_P],
    "rdfsq_quantize": [_P, _I, _P, _P, _LL, _LL, _I, _I, _P],
    "rdfsq_dequantize": [_P, _P, _P, _I, _LL, _LL, _I, _I, _P],
    "decode_bf16": [_P] * 6 + [_I] * 13 + [_P],
    "decode_q8": [_P] * 8 + [_I] * 13 + [_P],
    "decode_paged_bf16": [_P] * 7 + [_I] * 13 + [_P],
    "decode_paged_q8": [_P] * 9 + [_I] * 13 + [_P],
    "nf_quantize": [_P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "nf_dequantize": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "wq_matmul_bf16_gemv": [_P] * 6 + [_I] * 8 + [_P],
    "wq_matmul_bf16_wgmma": [_P] * 5 + [_I] * 6 + [_P],
    "wq_matmul_f32": [_P] * 5 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def refuse_dtensor(name: str, *tensors) -> None:
    """A kernel takes one rank's local tensors: raise ``TypeError`` on a
    ``DTensor`` (a CUDA one would reach the launch with a rank's local
    pointer and the global shape, a CPU one would run the plain version op
    by op across the mesh).  Sharded callers hand a kernel their local
    shards through ``local_map`` (``attention_ops.on_local_heads``)."""
    mod = sys.modules.get("torch.distributed.tensor")
    dtensor = getattr(mod, "DTensor", None)
    if dtensor is not None and any(isinstance(t, dtensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, got a DTensor: call "
                        "it on the local shard (local_map)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    return BUILD_DIR / f"librepro_torch_kernels_{_digest(sources)}.so"


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns its
    path.  ``build.log`` beside it keeps nvcc's and ptxas's output."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        failed = [src.name for src, _, proc in procs if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = tmp / lib_path.name
        subprocess.run([nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp_lib),
                        *[str(obj) for _, obj, _ in procs]], check=True)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, fn_name: str, *args) -> None:
    """Call ``fn_name`` of the library, raise on a CUDA error, count it."""
    err = getattr(library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")
    launches[kernel] += 1


def current_stream(device_index: Optional[int] = None) -> int:
    """The handle of PyTorch's current stream on the device (the current
    device by default), read without building a Stream object."""
    if device_index is None:
        device_index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(device_index)
