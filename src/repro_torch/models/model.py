"""Model façade: loss, train and serve steps.

The port of ``repro.models.model``'s loss and steps:

  * :func:`loss_fn` / :func:`make_train_step`: LM cross-entropy (+ the
    MoE aux loss), gradients by ``torch.autograd.grad`` on the parameter
    leaves (each in its leaf's dtype), AdamW; optional microbatched
    gradient accumulation;
  * :func:`prefill_step` / :func:`serve_step`: the inference paths;
  * :data:`SHAPES` / :func:`input_specs`: the dry run's (arch x shape)
    cells and meta-tensor stand-ins for their inputs.

The reference's partition-spec functions describe TPU meshes; one card
has none, so they are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

F32 = torch.float32


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE. logits (..., V) -> f32 stable logsumexp."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(params, cfg, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    tokens = batch["tokens"]
    logits, aux = tf.forward_train(params, cfg, tokens,
                                   positions=batch.get("positions"),
                                   vision=batch.get("vision"))
    if cfg.n_codebooks > 1:
        # tokens (B, C, S); logits (B, S, C, V): next token per codebook
        labels = tokens[:, :, 1:]
        ce = cross_entropy(torch.movedim(logits[:, :-1], 2, 1), labels)
    else:
        ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ---------------------------------------------------------------------------
# Train / serve steps
# ---------------------------------------------------------------------------
def value_and_grad(params, cfg, batch: Dict):
    """(loss, grads): the loss detached, the gradients a tree like
    `params`, each in its parameter's dtype (zeros where unused)."""
    flat = tree_mod.leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, _ = loss_fn(tree_mod.unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_mod.unflatten(params, list(grads))


def make_train_step(cfg, opt: adamw.AdamWConfig, accum_steps: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    metrics); the update writes into `params` and `opt_state` (see
    :func:`repro_torch.optim.adamw.update`).

    `accum_steps > 1` splits the batch into microbatches along the first
    axis of every input and sums their gradients, as the reference does,
    from ``zeros_like(params)``: in the parameters' dtype (bf16 for the
    matrices), then divided by `accum_steps` in that dtype."""

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, cfg, batch)
        else:
            def micro(x, i):
                b = x.shape[0]
                return x.reshape(accum_steps, b // accum_steps,
                                 *x.shape[1:])[i]
            grads = tree_mod.tree_map(torch.zeros_like, params)
            l_sum = torch.zeros((), dtype=F32,
                                device=tree_mod.leaves(params)[0].device)
            for i in range(accum_steps):
                mb = {k: micro(v, i) for k, v in batch.items()}
                l, g = value_and_grad(params, cfg, mb)
                for acc, gi in zip(tree_mod.leaves(grads),
                                   tree_mod.leaves(g)):
                    acc.add_(gi)
                l_sum = l_sum + l
                del g
            for g in tree_mod.leaves(grads):
                g.div_(accum_steps)
            loss = l_sum / accum_steps
        params, opt_state, om = adamw.update(opt, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def prefill_step(params, cfg, batch: Dict):
    return tf.forward_prefill(params, cfg, batch["tokens"],
                              positions=batch.get("positions"),
                              vision=batch.get("vision"))


def serve_step(params, cfg, token, caches, ctx_len):
    return tf.decode_step(params, cfg, token, caches, ctx_len)


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; no allocation)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    """Meta tensors (shape and dtype, no storage) for every model input of
    this (arch x shape) cell; a decode cell's caches follow
    :func:`repro_torch.models.transformer.init_cache`'s layout."""
    b, s = cell.global_batch, cell.seq_len
    i32, meta = torch.int32, torch.device("meta")

    def stand_in(shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=meta)

    if cell.kind in ("train", "prefill"):
        out = {"tokens": stand_in((b, cfg.n_codebooks, s)
                                  if cfg.n_codebooks > 1 else (b, s))}
        if cfg.rope == "mrope":
            out["positions"] = stand_in((3, b, s))
        if cfg.vision_tokens:
            out["vision"] = stand_in((b, cfg.vision_tokens, cfg.vision_dim),
                                     torch.bfloat16)
        return out
    # decode: one token, caches of length seq_len
    return {"token": stand_in((b, cfg.n_codebooks) if cfg.n_codebooks > 1
                              else (b,)),
            "caches": tf.init_cache(cfg, b, s, device=meta),
            "ctx_len": stand_in(())}
