"""Build the hand-written CUDA kernels with `nvcc` and load them with ctypes.

Each library is one `.cu` source under ``csrc/`` with a plain C interface
(it may include shared ``csrc/*.cuh`` headers), compiled for Hopper
(``sm_90a``) into a shared library at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

Sources and output both live in this package's directory: the library lands
in ``_build/`` beside ``csrc/`` (git ignores it), named by a hash of the
source, of every header it includes and of the flags, so an edited kernel
or shared header is never served from a stale build.  An installed copy
carries ``csrc/*.cu`` and ``csrc/*.cuh`` as package data and builds the same
way, provided its directory is writable.  A missing `nvcc` or a failed compile
raises; there is no fallback.  Nothing here runs at import time.

:data:`LAUNCHES` is the one launch count of every kernel: each wrapper adds
one to its kernel's key where it launches the kernel, and to
``"<kernel>_ref"`` where it runs the plain version instead.
``"decode_attention"`` counts K4's launches over a decode step's dense
caches apart from the serve loop's ``"paged_attention"``, and
``"decode_attention_ref"`` the decode steps that keep the model's einsums.
``"attention_sinks"`` counts K4's launches with a sink per head, through
either entry, and ``"attention_sinks_ref"`` the plain versions' calls with
sinks (K4's and the decode einsums'); ``"flash_attention_sinks"`` and
``"flash_attention_sinks_ref"`` the same for K5.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARIES = ("mesi", "mesi_dyn", "paged_attention", "cache_sim",
             "stream_triad", "flash_attention")
KERNELS = ("mesi_segment", "mesi_dyn_segment", "paged_attention",
           "cache_sim", "stream_triad", "flash_attention",
           "decode_attention", "attention_sinks", "flash_attention_sinks")
LAUNCHES: Dict[str, int] = {k + s: 0 for k in KERNELS for s in ("", "_ref")}
# the KDA mixer's chunks scanned in prefill and decode steps run, counted
# beside the kernels (it runs in PyTorch operations)
LAUNCHES.update(kda_chunks=0, kda_steps=0)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def sources(name: str) -> List[pathlib.Path]:
    """`csrc/<name>.cu` and every ``csrc`` header it includes, transitively
    (quoted ``#include``s only; system headers are not followed)."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(path.parent / inc.decode()
                    for inc in _INCLUDE.findall(path.read_bytes()))
    return seen


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


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
