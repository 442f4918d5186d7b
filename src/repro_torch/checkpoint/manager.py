"""Checkpoints of tensor trees: atomic, asynchronous, keep-K.

Layout per step:  <dir>/step_000123/
    manifest.json    — tree structure, leaf names, shapes, dtypes, step
    leaf_NNNNN.npy   — one file per leaf (host numpy)

The trees are the ones the sweep executors and the training runtime
store: tuples, NamedTuples (the optimizer's ``OptState``), lists and
dicts of tensors or NumPy arrays, nested freely.  Dict keys
flatten in sorted order and the manifest's structure string is written as
the JAX package's ``str(treedef)`` writes it, so a checkpoint directory
written by either package restores in the other.

Properties the executors rely on:
  * **atomic**: written to `tmp_step_k`, then renamed — a crash never
    leaves a half checkpoint that restore would pick up;
  * **async**: `save(..., blocking=False)` copies every leaf to host
    memory first (a synchronous device-to-host copy) and writes on a
    worker thread;
  * **typed restore**: a leaf whose `like` is a tensor comes back as a
    tensor of that dtype on that tensor's device, a NumPy leaf as NumPy;
  * keeps the newest `keep` checkpoints, deletes older ones after success.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod


class CheckpointError(RuntimeError):
    """A checkpoint failed validation on restore (structure/shape/treedef).

    Raised instead of ``assert`` so the checks survive ``python -O`` —
    restoring a mismatched carry must never silently produce wrong
    state.
    """


def _flatten(tree) -> Tuple[List[Any], str]:
    """Leaves in order and the structure string, ``PyTreeDef(...)`` with
    ``*`` for a leaf."""
    return tree_mod.leaves(tree), f"PyTreeDef({_structure(tree)})"


def _structure(node) -> str:
    """`node`'s part of the structure string, as ``str(treedef)`` writes
    it: a NamedTuple is ``CustomNode(namedtuple[Name], [...])``."""
    if tree_mod.is_leaf(node):
        return "*"
    parts = [_structure(v) for _, v in tree_mod.children(node)]
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {s}" for k, s in
                               zip(sorted(node), parts)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(parts) + "]"
    if hasattr(node, "_fields"):
        return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                + ", ".join(parts) + "])")
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


def _to_host(x) -> np.ndarray:
    """A host copy of `x` that shares no memory with it, so an async save
    is not changed by in-place updates to the tree (``.cpu()`` of a CPU
    tensor would return the tensor itself)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:      # NumPy has no bfloat16: its bits
            return x.view(torch.int16).numpy()
        return x.numpy()
    return np.array(x, copy=True)


def _dtype_name(x, host: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def _from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` as a tensor of `like`'s dtype on its device; a bfloat16 leaf
    is stored as its 16 bits (int16 here, a 2-byte void type from JAX)."""
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "iuV":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # A crash mid-save leaves a tmp_step_* dir behind; restore never
        # reads them (all_steps globs step_*), but they accumulate and a
        # later save to the same step would inherit stale leaves, so
        # sweep them on startup.
        for stale in self.dir.glob("tmp_step_*"):
            shutil.rmtree(stale, ignore_errors=True)

    # ---- save ----------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        self.wait()                         # one in-flight save at a time
        leaves, treedef = _flatten(tree)
        named = [(f"leaf_{i:05d}", _to_host(x))     # D2H copy happens here
                 for i, x in enumerate(leaves)]
        dtypes = [_dtype_name(x, a) for x, (_, a) in zip(leaves, named)]
        manifest = {
            "step": step,
            "treedef": treedef,
            "leaves": [{"name": n, "shape": list(a.shape), "dtype": dt}
                       for (n, a), dt in zip(named, dtypes)],
        }

        def work():
            try:
                tmp = self.dir / f"tmp_step_{step:06d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for name, arr in named:
                    np.save(tmp / f"{name}.npy", arr)
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                final = self.dir / f"step_{step:06d}"
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except BaseException as e:      # noqa: BLE001
                self._error = e

        if blocking:
            work()
            self.raise_if_failed()
        else:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err}") from err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:06d}", ignore_errors=True)

    # ---- restore ---------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any) -> Tuple[int, Any]:
        """Restore into the structure of `like`: tensor leaves come back
        as tensors of `like`'s dtype on `like`'s device, the rest as NumPy
        arrays of `like`'s dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:06d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves_like, treedef = _flatten(like)
        stored_treedef = manifest.get("treedef")
        if stored_treedef is not None and stored_treedef != treedef:
            raise CheckpointError(
                f"checkpoint treedef mismatch at step {step}: stored "
                f"{stored_treedef}, `like` has {treedef}")
        if len(manifest["leaves"]) != len(leaves_like):
            raise CheckpointError(
                f"checkpoint/model structure mismatch at step {step}: "
                f"{len(manifest['leaves'])} stored leaves vs "
                f"{len(leaves_like)} in `like`")
        out = []
        for meta, ref in zip(manifest["leaves"], leaves_like):
            arr = np.load(d / f"{meta['name']}.npy")
            if tuple(arr.shape) != tuple(ref.shape):
                raise CheckpointError(
                    f"{meta['name']}: stored shape {tuple(arr.shape)} != "
                    f"expected {tuple(ref.shape)} at step {step}")
            if isinstance(ref, torch.Tensor):
                out.append(_from_host(arr, ref))
            else:
                out.append(arr.astype(np.asarray(ref).dtype))
        return step, tree_mod.unflatten(like, out)
