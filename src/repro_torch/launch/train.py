"""Training entry point: the end-to-end loop with checkpoints and restarts.

The port of ``repro.launch.train``: data (:func:`repro_torch.data.
batch_at_step`) -> ``forward_train`` -> loss -> gradients (optionally
accumulated over microbatches) -> AdamW, driven by
:class:`repro_torch.runtime.TrainingRuntime`, which checkpoints every
``ckpt_every`` steps and restarts from the newest checkpoint after a
``WorkerFailure``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --steps 200 --d-model 512 --layers 8

Without ``--device`` it trains on the CUDA card.  :func:`run` is the body
of the reference's ``main`` on any configuration (``main`` passes the
smoke config of ``--arch``, as the reference does: its ``--smoke`` flag is
on whatever is passed); the weights are drawn from seed 0
(:func:`repro_torch.models.transformer.init_params`) or passed in, e.g.
carried over from JAX by :func:`repro_torch.convert.model_params`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.device import resolve_device
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.memory import plan_training
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime import RuntimeConfig, TrainingRuntime, WorkerFailure


def build_config(args):
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        d = args.d_model
        over.update(d_model=d, d_ff=args.d_ff or int(3.5 * d) // 16 * 16)
        if cfg.block_pattern != ("rwkv",):
            over["head_dim"] = d // cfg.n_heads if d % cfg.n_heads == 0 else 64
    if args.vocab:
        over["vocab_size"] = args.vocab
    return dataclasses.replace(cfg, **over)


def run(cfg, *, steps: int = 100, batch: int = 8, seq: int = 256,
        lr: float = 3e-4, accum_steps: int = 1,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        fail_at: int = 0, log_every: int = 10, device=None,
        params: Optional[Dict] = None) -> Dict:
    """Train `cfg` for `steps` steps on `device` (default: the CUDA card).

    `ckpt_dir` defaults to ``repro_ckpt`` under the temporary directory;
    `fail_at` injects one ``WorkerFailure`` (host 1) before that step;
    `log_every` > 0 prints every `log_every`-th step and a summary, as
    the reference's ``main`` does.  The runtime's state is updated in
    place, so passed-in `params` are trained.

    Returns a dict: ``log`` (the runtime's events), ``restarts``,
    ``evicted`` (hosts), ``state`` ((params, OptState)), ``end_step`` and
    ``seconds`` (host wall time of the loop; each step ends in a device
    synchronization, since its metrics are read as floats).
    """
    dev = resolve_device(device)
    if params is None:
        params = tf.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), dev)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    dc = DataConfig(batch_per_shard=batch, seq_len=seq)
    opt_state = adamw.init(params)
    step_impl = M.make_train_step(cfg, opt_cfg, accum_steps=accum_steps)

    def step_fn(state, step):
        params, opt_state = state
        b = batch_at_step(cfg, dc, step, device=dev)
        params, opt_state, metrics = step_impl(params, opt_state, b)
        # floats, so the runtime's step timer sees the device's work
        metrics = {k: float(v) for k, v in metrics.items()}
        return (params, opt_state), metrics

    ckpt = CheckpointManager(ckpt_dir, keep=3)
    pending = [fail_at]

    def injector(step):
        if pending[0] and step == pending[0]:
            pending[0] = 0          # fire once
            raise WorkerFailure(host=1, msg="injected failure (demo)")

    rt = TrainingRuntime(step_fn, ckpt, RuntimeConfig(ckpt_every=ckpt_every),
                         n_hosts=4, failure_injector=injector)
    t0 = time.time()
    state, end_step = rt.run((params, opt_state), 0, steps)
    dt = time.time() - t0

    steps_logged = [e for e in rt.log if e["event"] == "step"]
    if log_every > 0:
        for e in steps_logged[::log_every]:
            print(f"step {e['step']:5d} loss={e.get('loss', 0):.4f} "
                  f"lr={e.get('lr', 0):.2e} {e['dt']*1e3:.0f}ms")
        if steps_logged:
            first, last = steps_logged[0], steps_logged[-1]
            print(f"loss {first.get('loss'):.4f} -> {last.get('loss'):.4f} "
                  f"over {len(steps_logged)} steps in {dt:.1f}s "
                  f"(restarts={rt.restarts})")
    return {"log": rt.log, "restarts": rt.restarts,
            "evicted": list(rt.fleet.evicted), "state": state,
            "end_step": end_step, "seconds": dt}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="granite-3-8b")
    # the reference's flag: store_true with default True, so always on
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a WorkerFailure at this step (demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = build_config(args)
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.arch} params={cfg.n_params():,} devices={n_dev} "
          f"({dev})")
    plan = plan_training(cfg, n_devices=max(n_dev, 1), batch=args.batch,
                         seq=args.seq)
    print("tier plan:", {p.name: p.tier for p in plan.placements})
    run(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        accum_steps=args.accum_steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at=args.fail_at,
        log_every=args.log_every, device=dev)


if __name__ == "__main__":
    main()
