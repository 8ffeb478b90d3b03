"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
loaded with ``ctypes``; ``launch`` calls one of its entry points on
PyTorch's current stream and raises on the CUDA error it returns. The
library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library
is never loaded. Nothing is built when a module is imported: the first
launch builds, or ``build_all`` builds every kernel at once, one ``nvcc``
per source, started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "kernels"
#: ``-Xptxas -v`` makes the build log report registers, shared memory
#: and spills per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("masked_matmul", "rmsnorm", "flash_attention", "ssd_scan")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME``/``CUDA_PATH`` or the
    toolkit's default prefix; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives for the current source."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> Tuple[Path, Optional[Path],
                               Optional[subprocess.Popen]]:
    so = library_path(name)
    if so.exists():
        return so, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, tmp, proc


def _finish(name: str, so: Path, tmp: Optional[Path],
            proc: Optional[subprocess.Popen]) -> str:
    log_path = so.with_suffix(".log")
    if proc is None:
        return log_path.read_text() if log_path.exists() else ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)        # atomic: a reader never sees half a library
    return log


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Build every named kernel, all ``nvcc`` runs in parallel; returns
    each kernel's compiler output (the ptxas resource report)."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built on first use and loaded once."""
    with _lock:
        if name not in _libs:
            so, tmp, proc = _start(name)
            _finish(name, so, tmp, proc)
            _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]


def launch(name: str, symbol: str, argtypes: Sequence[Any],
           device: torch.device, *args) -> None:
    """Call the C entry point ``symbol`` of kernel ``name`` with ``args``
    and the current stream of ``device``, which it launches on; raises if
    the launch failed (the entry returns ``cudaGetLastError()``, since a
    launch the card refuses never runs and a later synchronize would not
    report it)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: kernel launch failed with CUDA "
                           f"error {err}")
