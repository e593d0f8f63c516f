"""Build and load the port's CUDA kernels: ``nvcc`` into a shared
library with a plain C interface, bound with ``ctypes``.

Each library is compiled for ``sm_90a`` at first use into
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of
its sources and flags so that an edited source is rebuilt. Builds of
several libraries run as parallel ``nvcc`` processes. Nothing here runs
at import time: the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """One shared library: a name and its ``.cu`` sources."""
    name: str
    sources: Tuple[Path, ...]

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources:
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self.digest()}.so"

    @property
    def log_path(self) -> Path:
        """``nvcc -Xptxas -v`` output of the build (registers, spills)."""
        return self.path.with_suffix(".ptxas.txt")


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def build(libs: Sequence[KernelLibrary]) -> None:
    """Compile every library that is not built yet, all ``nvcc``
    processes started together; raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib in libs:
        if lib.path.exists():
            continue
        tmp = lib.path.with_name(f"{lib.path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in lib.sources)]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.name}:\n{out}")
            continue
        lib.log_path.write_text(out)
        os.replace(tmp, lib.path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(lib: KernelLibrary) -> ctypes.CDLL:
    """Build ``lib`` if needed and load it."""
    build([lib])
    return ctypes.CDLL(str(lib.path))
