"""Build the port's CUDA C++ sources with ``nvcc`` and load them with ctypes.

Each ``shotvae_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout, under a name that carries a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused. No PyTorch
header is included, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home})")
    return nvcc


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is built; returns
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills), empty
    where the library was already built."""
    src, lib = _target(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # no half-written library
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    log = out.stdout + out.stderr
    if out.returncode:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
    return _loaded[name]


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
