"""Checkpoints of tensor trees: atomic, asynchronous, keep-K.

Layout per step:  <dir>/step_000123/
    manifest.json    — tree structure, leaf names, shapes, dtypes, step
    leaf_NNNNN.npy   — one file per leaf (host numpy)

The trees are the ones the sweep executors store: tuples (or lists) of
tensors and dicts of tensors or NumPy arrays, nested freely.  Dict keys
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


class CheckpointError(RuntimeError):
    """A checkpoint failed validation on restore (structure/shape/treedef).

    Raised instead of ``assert`` so the checks survive ``python -O`` —
    restoring a mismatched carry must never silently produce wrong
    state.
    """


def _flatten(tree) -> Tuple[List[Any], str]:
    """Leaves in order and the structure string, ``PyTreeDef(...)`` with
    ``*`` for a leaf."""
    leaves, structure = _flatten_node(tree)
    return leaves, f"PyTreeDef({structure})"


def _flatten_node(tree) -> Tuple[List[Any], str]:
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, s = _flatten_node(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {s}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for v in tree:
            sub, s = _flatten_node(v)
            leaves += sub
            parts.append(s)
        if isinstance(tree, list):
            return leaves, "[" + ", ".join(parts) + "]"
        return leaves, "(" + ", ".join(parts) + ("," if len(parts) == 1
                                                 else "") + ")"
    return [tree], "*"


def _unflatten(tree, leaves: List[Any]):
    """`tree`'s structure with its leaves replaced, in `_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
        manifest = {
            "step": step,
            "treedef": treedef,
            "leaves": [{"name": n, "shape": list(a.shape),
                        "dtype": str(a.dtype)} for n, a in named],
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
                out.append(torch.from_numpy(arr).to(device=ref.device,
                                                    dtype=ref.dtype))
            else:
                out.append(arr.astype(np.asarray(ref).dtype))
        return step, _unflatten(like, out)
