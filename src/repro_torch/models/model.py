"""Model façade: loss, train and serve steps.

The port of ``repro.models.model``'s loss and steps:

  * :func:`loss_fn` / :func:`make_train_step`: LM cross-entropy (+ the
    MoE aux loss), gradients by ``torch.autograd.grad`` on the parameter
    leaves (each in its leaf's dtype), AdamW; optional microbatched
    gradient accumulation;
  * :func:`prefill_step` / :func:`serve_step`: the inference paths.

The reference's ``input_specs`` and partition-spec functions describe
TPU meshes for its dry run and are not ported (ROADMAP item 12).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
