"""The other flavours of the port's ``attn`` block against the JAX package,
in float32 at smoke size (rtol = atol = 1e-5, as in ``test_torch_models``):
qk-norm (stablelm), plain GQA (starcoder2), M-RoPE with a vision prefix
(qwen2-vl), sinusoidal positions with two codebooks and GeLU (musicgen),
and attention over a whole sequence without a cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

from test_torch_models import _close_caches, _models, close, jdecode, jprefill


@pytest.mark.parametrize("arch", ["stablelm-12b", "starcoder2-3b",
                                  "qwen2-vl-2b", "musicgen-large"])
def test_other_attention_archs_match_jax(arch):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(arch), dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.key(3))
    tparams = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(11)
    lead = (2,) if jcfg.n_codebooks == 1 else (2, jcfg.n_codebooks)
    toks = rng.integers(0, jcfg.vocab_size, lead + (12,)).astype(np.int32)
    vision = None
    if jcfg.vision_tokens:
        vision = rng.standard_normal(
            (2, jcfg.vision_tokens, jcfg.vision_dim)).astype(np.float32)
    jl, jcache = jprefill(
        jparams, jcfg, jnp.asarray(toks),
        vision=None if vision is None else jnp.asarray(vision))
    tl, tcache = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(toks),
        vision=None if vision is None else torch.from_numpy(vision))
    close(jl, tl)
    jcache = jtf.pad_cache(jcache, jcfg, 14)
    tcache = ttf.pad_cache(tcache, tcfg, 14)
    for ctx in (12, 13):
        tok = rng.integers(0, jcfg.vocab_size, lead).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                     jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close(jl, tl)
        _close_caches(jcache, tcache, "float32")


def test_attention_without_cache_matches_jax():
    jcfg, tcfg, jparams, tparams = _models("float32")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["segments"][0]["b0"]["attn"])
    want = jattn.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn.attention(tparams["segments"][0][0]["b0"]["attn"],
                          torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    close(want, got)
