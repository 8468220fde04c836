"""Atomic builds of native libraries (the CUDA kernels of ops/build.py, the
tokenizer of data/_native_tokenizer.py).

A library's name carries the hash of what it is built from, so an edited
source rebuilds and an unchanged one is reused. Builds run under an exclusive
file lock, each compiler writes a temporary file, and only `os.replace`
publishes it: concurrent processes build a library once, and none can load a
half-written file. Imports no torch.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path


def hashed_target(build_dir: Path, stem: str, *parts: bytes) -> Path:
    """build_dir / "<stem>-<16 hex digits of sha256 over parts>.so"."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return Path(build_dir) / f"{stem}-{h.hexdigest()[:16]}.so"


def build_missing(jobs: dict[str, tuple[list[str], Path]], lock: Path) -> dict[str, str]:
    """Under an exclusive lock on `lock`, run `cmd + ["-o", <temporary file>]`
    for each job (name → (cmd, out)) whose `out` does not exist, all started
    together, and publish each success with `os.replace`. Returns name →
    compiler output of the builds that ran; raises RuntimeError naming every
    failure (its temporary file removed)."""
    lock = Path(lock)
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        procs = {}
        for name, (cmd, out) in jobs.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("the build failed for " + "\n".join(failed))
    return logs
