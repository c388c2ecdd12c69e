"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries land in ``build/kernels/`` at the
repository root, named by a hash of their sources and flags, so an edited
source rebuilds and an unchanged one loads as built. ``build()`` starts
one ``nvcc`` per stale source, all at once, and waits for every one.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc",
           "library_path", "source_digest", "is_built", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("addtree", "conv_window", "fused_cwp", "qmatmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the hash of every
    source in ``csrc/`` it may include and the nvcc flags."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; known: {SOURCES}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def source_digest() -> str:
    """sha256 over the nvcc flags and every source in ``csrc/``: the
    kernel build a plan artifact's fingerprint records."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def is_built(names=SOURCES) -> bool:
    """True when every library in ``names`` is built from the current
    sources, so loading them runs no nvcc."""
    return all(library_path(n).exists() for n in names)


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every stale library in ``names`` with one nvcc each, all
    started together. Returns {name: {"seconds", "built", "ptxas"}};
    raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            report[name] = {"seconds": 0.0, "built": False, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        os.replace(tmp, lib)
        report[name] = {"seconds": time.perf_counter() - t0, "built": True,
                        "ptxas": out.strip()}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
