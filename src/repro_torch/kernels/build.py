"""Build the hand-written CUDA kernels with `nvcc` and load them with ctypes.

Each library is one `.cu` source under ``csrc/`` with a plain C interface,
compiled for Hopper (``sm_90a``) into a shared library at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

Sources and output both live in this package's directory: the library lands
in ``_build/`` beside ``csrc/`` (git ignores it), named by a hash of the
source so an edited kernel is never served from a stale build.  An installed
copy carries ``csrc/*.cu`` as package data and builds the same way, provided
its directory is writable.  A missing `nvcc` or a failed compile
raises; there is no fallback.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARIES = ("mesi",)


class KernelBuildError(RuntimeError):
    """`nvcc` is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (CUDA toolkit required to build "
                           "the repro_torch kernels)")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = LIBRARIES) -> Dict[str, str]:
    """Compile every library that is not built yet, all `nvcc`s at once.

    Returns ``{name: ptxas report}`` for the libraries compiled by this
    call (register and shared-memory use per kernel, from ``-Xptxas -v``).
    """
    pending = {n: _target(n) for n in names if not _target(n).exists()}
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in pending.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
            reports[name] = log
    if errors:
        raise KernelBuildError("\n".join(errors))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed (cached per process)."""
    build((name,))
    return ctypes.CDLL(str(_target(name)))
