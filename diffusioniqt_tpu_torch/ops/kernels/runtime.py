"""Building, loading and calling the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use (or through :func:`build` ahead of time, all sources
in parallel) into ``build/torch_kernels/<hash>/`` under the repository
root, where ``<hash>`` covers the sources, the shared headers and the
flags, so an unchanged checkout never rebuilds. Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("halo", "conv3d", "fused_block", "fused_block_small", "flash_attention",
           "group_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_DRIVER_FNS: Dict[str, int] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return _build_dir() / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: compiler log}``
    (``-Xptxas -v``: registers, shared memory, spills) for the sources it
    built; raises with the compiler's output if one fails."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def c_function(lib_name: str, fn_name: str, argtypes: Sequence):
    """A C entry point with its argument types declared (every pointer and
    the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def driver_function(name: str) -> int:
    """Address of a CUDA driver API function (``libcuda.so.1``, which the
    CUDA runtime has already loaded). The kernels' libraries do not link
    libcuda; a launcher that needs a CUDA driver function, as the TMA
    descriptors do, takes its address from here."""
    fn = _DRIVER_FNS.get(name)
    if fn is None:
        fn = ctypes.cast(getattr(ctypes.CDLL("libcuda.so.1"), name), ctypes.c_void_p).value
        _DRIVER_FNS[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The card's SMs: the persistent kernels' grid is at most one CTA each."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name} kernel: {what}")


def plain_vjp(plain, inputs: List[Optional[torch.Tensor]], needs,
              grad: torch.Tensor, *consts):
    """Backward of a kernel through its plain version: recompute the plain
    forward under autograd and pull ``grad`` back to the inputs that need
    it (the Pallas kernels do the same with ``jax.custom_vjp``)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) if t is not None else None
                  for t, n in zip(inputs, needs)]
        out = plain(*leaves, *consts)
        wanted = [t for t, n in zip(leaves, needs) if n and t is not None]
        grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
    return [next(grads) if n and t is not None else None
            for t, n in zip(inputs, needs)]

