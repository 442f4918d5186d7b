"""One-card dry run: trace every (arch x shape) cell without allocating.

The port of ``repro.launch.dryrun``.  For each architecture and input
shape it builds stand-ins of the parameters
(:func:`repro_torch.models.transformer.param_shapes`), the inputs
(:func:`repro_torch.models.model.input_specs`) and, for a training cell,
the AdamW state, as fake tensors of the chosen device, and runs the
port's own step on them under ``FakeTensorMode``: ``make_train_step``
(``accum_steps`` and config overrides as in the reference),
``prefill_step`` or ``serve_step``.  Nothing is allocated on the device
and no kernel runs; what the trace counts:

  * FLOPs, by ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
    products);
  * bytes read and written by every operation, and by the matrix
    products alone (the reference's ``traffic`` / ``dot_traffic`` split);
  * an estimate of the peak live bytes on the device: every storage from
    its creation to its release, the arguments included, rounded up to
    the caching allocator's 512-byte blocks on CUDA;
  * argument and output bytes, and whether the peak fits one card's HBM.

The rows feed :mod:`repro_torch.roofline`.  The reference lowers each
cell onto a 16x16 (or 2x16x16) TPU mesh and reads XLA's analyses; one card
has no mesh, so its mesh flags (``--multi-pod``, ``--both-meshes``,
``--strategy``, ``--fsdp-pods``) and ``--save-hlo`` have no counterpart.

Usage:
  python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b \\
      --shape decode_32k --device cpu
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun_torch]

Without ``--device`` it traces fake tensors of the CUDA card (which must be
present), so the CUDA code path is the one traced.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_mod
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import spec
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

MESH_TAG = "1xH100"
_CUDA_BLOCK = 512          # the caching allocator's smallest block, bytes
_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
                   _aten.addbmm))


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str                      # ok | skipped | failed
    note: str = ""
    kind: str = ""
    seq_len: int = 0
    global_batch: int = 0
    accum_steps: int = 1
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: str = ""
    trace_s: float = 0.0
    flops: float = 0.0
    traffic_bytes: float = 0.0       # every operation's inputs and outputs
    dot_traffic_bytes: float = 0.0   # the matrix products' alone
    peak_memory_per_device: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    fits: bool = False

    def row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _tensors(tree_) -> list:
    return [x for x in pytree.tree_leaves(tree_)
            if isinstance(x, torch.Tensor)]


def _storage_bytes(tree_) -> int:
    """Bytes of the distinct storages under `tree_`."""
    seen = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree_)}
    return sum(seen.values())


class MemoryTrace(TorchDispatchMode):
    """Counts what the operations below it move and keep.

    ``traffic`` / ``dot_traffic``: bytes of every operation's tensor
    inputs and outputs (views and metadata queries move nothing and are
    skipped), and of the matrix products' alone.  ``live`` / ``peak``:
    bytes of the storages alive, each counted from the operation that
    made it, or from :meth:`track`, to its release, rounded up to `block`
    bytes.  The release callbacks may run on the autograd engine's
    threads.
    """

    def __init__(self, block: int = 1):
        super().__init__()
        self.block = block
        self.live = 0
        self.peak = 0
        self.traffic = 0
        self.dot_traffic = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._lock = threading.Lock()

    def track(self, tree_) -> None:
        for t in _tensors(tree_):
            st = t.untyped_storage()
            key = id(st)
            with self._lock:
                if key in self._refs:
                    continue
                n = -(-st.nbytes() // self.block) * self.block
                self._refs[key] = weakref.ref(
                    st, lambda _, key=key, n=n: self._release(key, n))
                self.live += n
                self.peak = max(self.peak, self.live)

    def _release(self, key: int, n: int) -> None:
        with self._lock:
            del self._refs[key]
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        made = _tensors(out)
        if made and not func.is_view:       # metadata queries return none
            moved = sum(t.numel() * t.element_size()
                        for t in _tensors((args, kwargs)) + made)
            self.traffic += moved
            if func.overloadpacket in _DOTS:
                self.dot_traffic += moved
        self.track(made)
        return out


def _fake_like(tree_, device):
    """Fake tensors of `device` shaped like the meta leaves of `tree_`
    (call under a ``FakeTensorMode``)."""
    return tree_mod.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree_)


def _cell(shape: Union[str, M.ShapeCell]) -> M.ShapeCell:
    return M.SHAPES[shape] if isinstance(shape, str) else shape


def _config(arch: str, overrides: Optional[dict]):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_cell(arch: str, shape: Union[str, M.ShapeCell], device,
               accum_steps: int = 1, overrides: Optional[dict] = None
               ) -> Tuple[Callable, tuple]:
    """(step, fake args) for one cell; call under a ``FakeTensorMode``.
    `shape` is a key of :data:`SHAPES` or a cell of one's own (the
    training runs' batch 1)."""
    cfg, cell = _config(arch, overrides), _cell(shape)
    params = _fake_like(tf.param_shapes(cfg), device)
    inputs = M.input_specs(cfg, cell)
    if cell.kind == "train":
        step = M.make_train_step(cfg, adamw.AdamWConfig(),
                                 accum_steps=accum_steps)
        return step, (params, adamw.init(params),
                      _fake_like(inputs, device))
    if cell.kind == "prefill":
        return (lambda p, b: M.prefill_step(p, cfg, b),
                (params, _fake_like(inputs, device)))
    # decode: one token at the last position of a full cache
    return (lambda p, tok, caches: M.serve_step(p, cfg, tok, caches,
                                                cell.seq_len - 1),
            (params, _fake_like(inputs["token"], device),
             _fake_like(inputs["caches"], device)))


def run_cell(arch: str, shape: Union[str, M.ShapeCell], accum_steps: int = 1,
             overrides: Optional[dict] = None, device=None) -> CellResult:
    """Trace one cell on fake tensors of `device` (default: the CUDA
    card); a cell that raises is returned as ``failed`` with its error."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    dev = resolve_device(device)
    cfg, cell = _config(arch, overrides), _cell(shape)
    res = CellResult(arch, cell.name, MESH_TAG, "skipped", kind=cell.kind,
                     seq_len=cell.seq_len, global_batch=cell.global_batch,
                     accum_steps=accum_steps, overrides=dict(overrides or {}),
                     device=str(dev))
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        res.note = ("full attention; 500k prefill is quadratic "
                    "(spec rule, DESIGN.md §6)")
        return res
    t0 = time.perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = build_cell(arch, cell, dev, accum_steps, overrides)
            mem = MemoryTrace(_CUDA_BLOCK if dev.type == "cuda" else 1)
            mem.track(args)
            flop_counter = FlopCounterMode(display=False)
            with flop_counter, mem:
                out = fn(*args)
            res.argument_bytes = _storage_bytes(args)
            res.output_bytes = _storage_bytes(out)
            del out, args
        res.status = "ok"
        res.flops = float(flop_counter.get_total_flops())
        res.traffic_bytes = float(mem.traffic)
        res.dot_traffic_bytes = float(mem.dot_traffic)
        res.peak_memory_per_device = int(mem.peak)
        res.fits = mem.peak <= spec.H100_HBM_BYTES
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        res.status = "failed"
        res.note = f"{type(e).__name__}: {e}"[:400]
    res.trace_s = round(time.perf_counter() - t0, 2)
    return res


def line(res: CellResult) -> str:
    """The one-line summary the CLI prints per cell."""
    return (f"[{res.status:7s}] {res.arch} {res.shape} {res.mesh} "
            f"trace={res.trace_s}s flops={res.flops:.3e} "
            f"peak={res.peak_memory_per_device / 2**30:.2f}GiB "
            f"fits={res.fits} {res.note}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(M.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in M.SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape required unless --all")
    dev = resolve_device(args.device)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    tag = MESH_TAG + (f"_{args.tag}" if args.tag else "")
    failed = 0
    for arch, shape in cells:
        res = run_cell(arch, shape, accum_steps=args.accum_steps, device=dev)
        (outdir / f"{arch}__{shape}__{tag}.json").write_text(
            json.dumps(res.row(), indent=1))
        print(line(res), flush=True)
        failed += res.status == "failed"
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
