"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process into a shared library with a
plain C interface — all processes started together — and loaded with ctypes.
Libraries land in `fvta_memexqa_torch/_build/` (not committed) under a name
carrying the hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. Nothing here runs at import: the first CUDA
launch triggers the build, and the CPU path never needs `nvcc`. The checks
and the launch counting shared by the kernel wrappers live here too.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # source stem → nvcc/ptxas output of the last build


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu whose library is missing; returns stem → path.
    A file lock keeps concurrent processes from building the same target."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC_DIR.glob("*.cu"))}
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        procs = {}
        for stem, (src, out) in targets.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (building all on first use)."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            for s, p in paths.items():
                _libs[s] = ctypes.CDLL(str(p))
        return _libs[stem]


def count_launch(wrapper, global_route: bool = False) -> None:
    """`wrapper.launches += 1`, and `wrapper.global_launches += 1` for a launch on
    the kernel's global route, under a lock: kernels launch from several threads
    (the serving engine's worker and the ingesting caller)."""
    with _count_lock:
        wrapper.launches += 1
        if global_route:
            wrapper.global_launches += 1


def check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
