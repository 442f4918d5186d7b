"""Deterministic synthetic data pipeline (sharded, resumable).

The port of ``repro.data.pipeline``.  Tokens are a pure function of
(seed, step, shard), drawn with NumPy exactly as the reference draws them,
so both packages see the same tokens bit for bit; restarting from a
checkpoint at step k reproduces the stream.  The stream is an order-1
Markov chain, so a model has something to learn.

Frontends for the stubbed modalities: musicgen gets (B, C, S) codebook
ids, qwen2-vl gets patch embeddings (bf16, from the same generator) and
M-RoPE positions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.rope import text_mrope_positions


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    batch_per_shard: int = 8
    seq_len: int = 256
    n_shards: int = 1
    shard_id: int = 0


def _markov_tokens(rng: np.random.Generator, b: int, s: int, vocab: int
                   ) -> np.ndarray:
    """Order-1 Markov stream: token_{t+1} = (a*token_t + noise) mod vocab."""
    a = 31
    x = np.empty((b, s), np.int64)
    x[:, 0] = rng.integers(0, vocab, b)
    noise = rng.integers(0, max(vocab // 64, 2), (b, s))
    for t in range(1, s):
        x[:, t] = (a * x[:, t - 1] + noise[:, t]) % vocab
    return x.astype(np.int32)


def batch_at_step(cfg, dc: DataConfig, step: int, device=None
                  ) -> Dict[str, torch.Tensor]:
    """The batch for (step, shard) on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, dc.shard_id]))
    b, s = dc.batch_per_shard, dc.seq_len
    if cfg.n_codebooks > 1:
        toks = np.stack([_markov_tokens(rng, b, s, cfg.vocab_size)
                         for _ in range(cfg.n_codebooks)], axis=1)
    else:
        toks = _markov_tokens(rng, b, s, cfg.vocab_size)
    out = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.rope == "mrope":
        out["positions"] = text_mrope_positions(b, s, device=dev)
    if cfg.vision_tokens:
        vision = rng.standard_normal((b, cfg.vision_tokens, cfg.vision_dim),
                                     np.float32)
        out["vision"] = torch.from_numpy(vision).to(dev, torch.bfloat16)
    return out


def iterate(cfg, dc: DataConfig, start_step: int = 0, device=None
            ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at_step(cfg, dc, step, device)
        step += 1
