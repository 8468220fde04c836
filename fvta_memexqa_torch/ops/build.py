"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process into a shared library with a
plain C interface — all processes started together — and loaded with ctypes.
Libraries land in `fvta_memexqa_torch/_build/` (not committed) under a name
carrying the hash of the source, the headers and the flags, built atomically
by utils/native_build. Nothing here runs at import: the first CUDA
launch triggers the build, and the CPU path never needs `nvcc`. The checks
and the launch counting shared by the kernel wrappers live here too.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading
from pathlib import Path

import torch

from fvta_memexqa_torch.utils.native_build import build_missing, hashed_target

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
    headers = [hdr.read_bytes() for hdr in sorted(CSRC_DIR.glob("*.cuh"))]
    return hashed_target(BUILD_DIR, src.stem, src.read_bytes(), *headers,
                         " ".join(NVCC_FLAGS).encode())


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu whose library is missing, one `nvcc` each, all
    started together; returns stem → path."""
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC_DIR.glob("*.cu"))}
    missing = {stem: out for stem, (_, out) in targets.items() if not out.exists()}
    if missing:
        nvcc = nvcc_path()
        build_log.update(build_missing(
            {stem: ([nvcc, *NVCC_FLAGS, str(targets[stem][0])], out)
             for stem, out in missing.items()}, BUILD_DIR / ".lock"))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (building all on first use)."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            for s, p in paths.items():
                _libs[s] = ctypes.CDLL(str(p))
        return _libs[stem]


def count_launch(wrapper, global_route: bool = False, bf16: bool = False) -> None:
    """`wrapper.launches += 1`, and `wrapper.global_launches += 1` for a launch on
    the kernel's global route, `wrapper.bf16_launches += 1` for one of its bf16
    activation instantiation, under a lock: kernels launch from several threads
    (the serving engine's worker and the ingesting caller, autograd's device
    thread). While a CUDA graph is captured (LaunchRecord.capturing) the launch
    is not made, so it goes to the graph's record instead."""
    with _count_lock:
        counts = _recording[-1] if _recording else None
        for attr, counted in (("launches", True), ("global_launches", global_route),
                              ("bf16_launches", bf16)):
            if not counted:
                continue
            if counts is None:
                setattr(wrapper, attr, getattr(wrapper, attr) + 1)
            else:
                counts[wrapper, attr] = counts.get((wrapper, attr), 0) + 1


_recording: list[dict] = []   # the records of the graphs being captured, innermost last


class LaunchRecord:
    """The kernel launches of a CUDA graph, as the counters see them: the
    capture launches nothing and adds nothing to a counter; each replay adds,
    for every wrapper, the launches the capture recorded."""

    def __init__(self):
        self.counts: dict[tuple, int] = {}   # (wrapper, counter attribute) → launches

    @contextlib.contextmanager
    def capturing(self):
        """Inside the block, count_launch records into this record (from any
        thread: autograd's device thread launches the backward's kernels)."""
        with _count_lock:
            _recording.append(self.counts)
        try:
            yield self
        finally:
            with _count_lock:
                _recording.pop()

    def replayed(self) -> None:
        """Add one replay's launches to the counters."""
        with _count_lock:
            for (wrapper, attr), n in self.counts.items():
                setattr(wrapper, attr, getattr(wrapper, attr) + n)


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
