"""The port's model stack and its paged-attention plain version against the
JAX package, on the CPU at smoke size.

Inputs come from numpy seeds; weights are the JAX ``init_params`` tree
carried over with :func:`repro_torch.convert.model_params`.  Tolerances:

* float32 (the algorithm): rtol = atol = 1e-5 for attention and the
  model's logits and caches — the two sum in different orders, nothing
  else differs (observed error ~2e-6 on logits of magnitude ~3);
* bfloat16 (the working type): atol = 6e-2, rtol = 2e-2 — a few bf16
  ulps at the logits' magnitude (ulp 1.6e-2 at 2-4), from products
  rounded to bf16 at different points by XLA and PyTorch;
* K4's plain version against ``repro.kernels.ref.paged_attention`` (the
  JAX oracle; its Pallas body does not run under JAX 0.9):
  rtol = atol = 3e-5 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

ARCH = "h2o-danube-3-4b"
# the reference's model calls, compiled once per configuration and shape
# (called eagerly, each re-traces its layer scan)
jprefill = jax.jit(jtf.forward_prefill, static_argnums=(1,))
jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=6e-2)}


def f32(x) -> np.ndarray:
    """A JAX array or a tensor as a float32 NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(a, b, dtype="float32"):
    np.testing.assert_allclose(f32(a), f32(b), **TOL[dtype])


def both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    dict(sq=24, skv=24, window=None, kv_chunk=8),      # causal
    dict(sq=24, skv=24, window=5, kv_chunk=8),         # SWA, window < S
    dict(sq=10, skv=21, window=None, kv_chunk=8),      # padded tail chunk
    dict(sq=7, skv=21, window=6, kv_chunk=16),         # both, end-aligned
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_attention_matches_jax(case, dtype):
    rng = np.random.default_rng(case["sq"] + case["skv"])
    b, n, kh, hd = 2, 4, 2, 16
    q = rng.standard_normal((b, case["sq"], n, hd)).astype(np.float32)
    k = rng.standard_normal((b, case["skv"], kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, case["skv"], kh, hd)).astype(np.float32)
    kw = dict(causal=True, window=case["window"], kv_chunk=case["kv_chunk"])
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, k, v))
    want = jattn.blockwise_attention(jq, jk, jv, **kw)
    got = tattn.blockwise_attention(tq, tk, tv, **kw)
    assert got.dtype == getattr(torch, dtype)
    close(want, got, dtype)


@pytest.mark.parametrize("ctx", [1, 9, 16])
def test_decode_attention_matches_jax(ctx):
    rng = np.random.default_rng(ctx)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    k = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  jnp.int32(ctx))
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)), ctx)
    close(want, got)
    lens = np.array([1, ctx, 16], np.int32)       # per-sequence lengths
    close(jattn.decode_attention(*map(jnp.asarray, (q, k, v, lens))),
          tattn.decode_attention(*map(torch.from_numpy, (q, k, v, lens))))


# ---------------------------------------------------------------------------
# the model: prefill, then teacher-forced decode
# ---------------------------------------------------------------------------
def _models(dtype: str, arch: str = ARCH, seed: int = 1):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tget_smoke(arch), dtype=dtype)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    tparams = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close_caches(jcache, tcache, dtype):
    for name in ("k", "v"):
        want = jcache[0]["b0"][name]
        got = np.stack([p["b0"][name].float().numpy() for p in tcache[0]])
        assert got.shape == want.shape
        close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """`forward_prefill` (20 tokens against smoke window 16: the rolled SWA
    cache) then 4 `decode_step`s fed the same tokens on both sides."""
    jcfg, tcfg, jparams, tparams = _models(dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    tl, tcache = ttf.forward_prefill(tparams, tcfg, torch.from_numpy(toks))
    assert tl.shape == jl.shape and tl.dtype == getattr(torch, dtype)
    close(jl, tl, dtype)
    _close_caches(jcache, tcache, dtype)
    jcache = jtf.pad_cache(jcache, jcfg, 26)
    tcache = ttf.pad_cache(tcache, tcfg, 26)
    for ctx in range(20, 24):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                     jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close(jl, tl, dtype)
        _close_caches(jcache, tcache, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_layer0_qkv_is_what_the_prefill_caches(dtype):
    """`prefill_layer0_qkv` gives the k and v that the prefill caches at
    layer 0: equal to the port's own prefill, close to JAX's (12 tokens,
    inside the smoke window, so the cache is not rolled)."""
    jcfg, tcfg, jparams, tparams = _models(dtype)
    assert tcfg.window is None or tcfg.window > 12
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    q, k, v = ttf.prefill_layer0_qkv(tparams, tcfg, torch.from_numpy(toks))
    _, tcache = ttf.forward_prefill(tparams, tcfg, torch.from_numpy(toks))
    _, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    assert q.shape == (2, 12, tcfg.n_heads, tcfg.head_dim)
    assert q.dtype == k.dtype == v.dtype == getattr(torch, dtype)
    for name, got in (("k", k), ("v", v)):
        assert torch.equal(got, tcache[0][0]["b0"][name])
        close(jcache[0]["b0"][name][0], got, dtype)


def test_decode_from_a_carried_cache_matches_jax():
    """A full-attention config (no window) decoding from JAX's own padded
    cache, carried over with `convert.dense_cache`."""
    jcfg = dataclasses.replace(jget_smoke("granite-3-8b"), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke("granite-3-8b"), dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.key(2))
    tparams = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    _, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    jcache = jtf.pad_cache(jcache, jcfg, 16)
    tcache = convert.dense_cache(jax.tree_util.tree_map(np.asarray, jcache),
                                 device="cpu")
    for ctx in (12, 13):
        tok = rng.integers(0, jcfg.vocab_size, (1,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                     jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close(jl, tl)
        _close_caches(jcache, tcache, "float32")


# ---------------------------------------------------------------------------
# the context length as an int and as a 0-d tensor (the form a CUDA graph
# captures), both against the reference
# ---------------------------------------------------------------------------
def _twin(caches):
    """A copy of a decode cache tree whose tensors share nothing."""
    return [[{b: {k: v.clone() for k, v in e.items()}
              for b, e in period.items()} for period in seg]
            for seg in caches]


def _jax_tree(tree):
    """A tree of dicts of tensors as JAX arrays."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _decode_both_ways(decode, reference, p, x, cfg, jcfg, cache, ctx):
    """`decode` with `ctx` as an int and as a 0-d tensor, each on its own
    copy of `cache`, against the JAX package's `reference` on the same
    inputs: outputs and the caches written within float32's tolerance."""
    jy, jcache = reference(_jax_tree(p), jnp.asarray(x.numpy()), jcfg,
                           _jax_tree(cache), jnp.int32(ctx))
    for length in (ctx, torch.tensor(ctx)):
        twin = {k: v.clone() for k, v in cache.items()}
        y, twin = decode(p, x, cfg, twin, length)
        close(jy, y)
        assert twin.keys() == jcache.keys()
        for k in twin:
            close(jcache[k], twin[k])


@pytest.mark.parametrize("arch,ctx", [
    ("granite-3-8b", 0),            # the first slot
    ("granite-3-8b", 9),            # the middle
    ("granite-3-8b", 15),           # the last slot
    ("granite-3-8b", 21),           # past the end: clamped at S - 1
    ("h2o-danube-3-4b", 21),        # a 16-token window: slot 21 % 16
    ("qwen2-vl-2b", 9),             # M-RoPE positions
    ("stablelm-12b", 9),            # qk-norm
])
def test_attention_decode_takes_the_context_length_as_a_tensor(arch, ctx):
    """`attention_decode` with `ctx_len` an int and a 0-d tensor: the
    output and the cache written those of the reference's."""
    jcfg, cfg = (dataclasses.replace(get(arch), dtype="float32")
                 for get in (jget_smoke, tget_smoke))
    gen = torch.Generator().manual_seed(ctx)
    p = tattn.attn_init(gen, cfg)
    x = torch.randn((2, 1, cfg.d_model), generator=gen)
    shape = (2, 16, cfg.n_kv_heads, cfg.head_dim)
    cache = {k: torch.randn(shape, generator=gen) for k in ("k", "v")}
    _decode_both_ways(tattn.attention_decode, jattn.attention_decode, p, x,
                      cfg, jcfg, cache, ctx)


@pytest.mark.parametrize("arch,ctx", [
    ("deepseek-v3-671b", 0),        # the first slot
    ("deepseek-v3-671b", 9),        # the middle
    ("deepseek-v3-671b", 15),       # the last slot
    ("deepseek-v3-671b", 21),       # past the end: clamped at S - 1
])
def test_mla_decode_takes_the_context_length_as_a_tensor(arch, ctx):
    """MLA's absorbed decode with `ctx_len` an int and a 0-d tensor: the
    output and the latent cache written those of the reference's."""
    jcfg, cfg = (dataclasses.replace(get(arch), dtype="float32")
                 for get in (jget_smoke, tget_smoke))
    gen = torch.Generator().manual_seed(ctx)
    p = tattn.mla_init(gen, cfg)
    x = torch.randn((2, 1, cfg.d_model), generator=gen)
    m = cfg.mla
    cache = {"ckv": torch.randn((2, 16, m.kv_lora_rank), generator=gen),
             "krope": torch.randn((2, 16, m.qk_rope_head_dim),
                                  generator=gen)}
    _decode_both_ways(tattn.mla_decode, jattn.mla_decode, p, x, cfg, jcfg,
                      cache, ctx)


@pytest.mark.parametrize("arch,prefill,capacity", [
    ("h2o-danube-3-4b", 20, 26),    # rolled in a 16-token window
    ("granite-3-8b", 12, 15),       # the last steps clamp at S - 1
    ("deepseek-v3-671b", 12, 15),   # MLA's latent cache, MoE layers
    ("qwen3-moe-235b-a22b", 12, 20),  # GQA with MoE layers
])
def test_decode_step_takes_the_context_length_as_a_tensor(arch, prefill,
                                                          capacity):
    """Teacher-forced `decode_step`s with `ctx_len` as an int and as a 0-d
    tensor from the reference's own prefill cache: logits and caches those
    of the reference's `decode_step` at every step."""
    jcfg, cfg, jparams, params = _models("float32", arch, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, prefill + 5)).astype(np.int32)
    _, jcache = jprefill(jparams, jcfg, jnp.asarray(toks[:, :prefill]))
    jcache = jtf.pad_cache(jcache, jcfg, capacity)
    cache = convert.dense_cache(jax.tree_util.tree_map(np.asarray, jcache),
                                device="cpu")
    twin = _twin(cache)
    for ctx in range(prefill, prefill + 5):
        tok = toks[:, ctx]
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(ctx))
        for length, caches in ((ctx, cache), (torch.tensor(ctx), twin)):
            got, _ = ttf.decode_step(params, cfg, torch.from_numpy(tok),
                                     caches, length)
            close(jl, got)
            for jseg, seg in zip(jcache, caches):
                for i, period in enumerate(seg):
                    for blk, entry in period.items():
                        for k, v in entry.items():
                            close(jseg[blk][k][i], v)


def test_graphable_takes_gqa_dense_rope_blocks_on_cuda_only():
    """The decode steps CUDA graphs take: every block attention (GQA or
    MLA) with a dense MLP or an MoE FFN, RoPE or M-RoPE positions, on a
    CUDA device."""
    from repro_torch.configs import ARCHS
    took = {a for a in ARCHS if ttf.graphable(tget_smoke(a), "cuda")}
    assert took == {"granite-3-8b", "h2o-danube-3-4b", "qwen2-vl-2b",
                    "stablelm-12b", "starcoder2-3b", "deepseek-v3-671b",
                    "qwen3-moe-235b-a22b"}
    assert not any(ttf.graphable(tget_smoke(a), dev) for a in took
                   for dev in ("cpu", "meta"))


def test_params_map_one_to_one():
    jcfg, tcfg, jparams, tparams = _models("bfloat16")
    mine = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert ttf.n_param_elements(tparams) == ttf.n_param_elements(mine)

    def names(tree, prefix=""):
        if isinstance(tree, dict):
            return {n for k, v in tree.items()
                    for n in names(v, f"{prefix}/{k}")}
        if isinstance(tree, list):
            return names(tree[0], prefix)
        return {(prefix, tuple(tree.shape), tree.dtype)}
    assert names(tparams) == names(mine)
    # same distributions: truncated at 2 sigma, fan-in scaled
    w = mine["segments"][0][0]["b0"]["attn"]["wqkv"].float()
    assert float(w.abs().max()) <= 2 * tcfg.d_model ** -0.5 + 1e-3
    assert abs(float(w.std()) * tcfg.d_model ** 0.5 - 0.88) < 0.05


# ---------------------------------------------------------------------------
# K4's plain version against the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kh,d,p,page,nblk", [
    (2, 8, 2, 64, 16, 4, 16),       # GQA 4
    (4, 4, 4, 32, 8, 8, 8),         # MHA
    (1, 16, 2, 128, 32, 2, 8),      # GQA 8, 2-token pages
    (3, 8, 2, 120, 20, 16, 4),      # danube's head_dim
])
def test_paged_attention_plain_matches_jax_oracle(b, h, kh, d, p, page, nblk):
    rng = np.random.default_rng(b * 100 + d)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((p, page, kh, d)).astype(np.float32)
    vp = rng.standard_normal((p, page, kh, d)).astype(np.float32)
    bt = rng.integers(0, p, (b, nblk)).astype(np.int32)
    cl = rng.integers(1, nblk * page + 1, (b,)).astype(np.int32)
    cl[0] = page + 1                # a partial last page
    want = np.asarray(jref.paged_attention(*map(jnp.asarray,
                                                (q, kp, vp, bt, cl))))
    tops.reset_launches()
    got = tops.paged_attention(*map(torch.from_numpy, (q, kp, vp, bt, cl)))
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  paged_attention_ref=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    # padding past the live blocks may hold anything, even ids outside
    # the pool: it is never read
    live = tpa.live_mask(torch.from_numpy(bt), torch.from_numpy(cl), page)
    padded = np.where(live.numpy(), bt, p + 1000).astype(np.int32)
    again = tops.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, padded, cl)))
    assert torch.equal(again, got)


def test_paged_attention_empty_context_and_checks():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    kp = rng.standard_normal((6, 4, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((6, 4, 2, 16)).astype(np.float32)
    bt = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    cl = np.array([0, 3, 8], np.int32)
    want = np.asarray(jref.paged_attention(*map(jnp.asarray,
                                                (q, kp, vp, bt, cl))))
    got = tops.paged_attention(*map(torch.from_numpy, (q, kp, vp, bt, cl)))
    assert np.all(got.numpy()[0] == 0) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt, cl)]
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tops.paged_attention(t[0][:, :3], *t[1:])
    bad = t[3].clone()
    bad[2, 1] = 6                   # a live entry outside the pool
    with pytest.raises(ValueError, match="outside the pool"):
        tops.paged_attention(t[0], t[1], t[2], bad, t[4])
    assert tpa.bound_bytes(t[0], t[1], t[3], t[4]) == (
        2 * q.nbytes + 11 * 2 * 2 * 16 * 4 + 4 * (3 + 3))

