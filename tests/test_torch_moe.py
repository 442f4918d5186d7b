"""The port's ``moe`` block kind against the JAX package, on the CPU at
smoke size: the dispatch tables bit for bit (the capacity cases of
``test_moe.test_dispatch_respects_capacity``), ``moe_ffn``'s output and
aux loss, and qwen3-moe-235b-a22b's prefill, decode and train step.

Tolerances are ``test_torch_models``'s: rtol = atol = 1e-5 for forward
values in float32, rtol 2e-2 / atol 6e-2 in bfloat16; gradients and Adam
state rtol 1e-4 / atol 1e-5.  The bfloat16 ``moe_ffn`` case also holds
the expert products to the reference's f32 results element by element.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw

from test_torch_models import _close_caches, close, jdecode, jprefill
from test_torch_train import GRAD_TOL, batch, carried, close_trees

ARCH = "qwen3-moe-235b-a22b"


def configs(dtype="float32", **moe_over):
    out = []
    for get in (jget_smoke, tget_smoke):
        cfg = get(ARCH)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe_over)))
    return out


@pytest.mark.parametrize("t,k,e,cap", [
    (1, 1, 2, None), (7, 2, 4, None), (31, 4, 8, None), (16, 3, 5, None),
    (23, 1, 3, None), (64, 2, 8, 24), (40, 2, 4, 40)])
def test_dispatch_tables_match_jax_bit_for_bit(t, k, e, cap):
    """Distinct experts per token; `cap` None is test_moe's tight capacity
    max(1, t*k // e), so assignments overflow and are dropped."""
    rng = np.random.default_rng(t * 100 + k * 10 + e)
    cap = cap or max(1, (t * k) // e)
    idx = np.stack([rng.choice(e, size=k, replace=False) for _ in range(t)]
                   ).astype(np.int32)
    w = rng.random((t, k)).astype(np.float32)
    jt, jw = jmoe._dispatch_tables(jnp.asarray(idx), jnp.asarray(w), e, cap,
                                   t)
    tt, tw = tmoe._dispatch_tables(torch.from_numpy(idx),
                                   torch.from_numpy(w), e, cap, t)
    assert tt.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("n_tokens", [1, 16, 1024, 4096])
def test_capacity_is_the_reference_formula(n_tokens):
    """At qwen3-moe-235b-a22b's full width: 80 slots at 1024 tokens."""
    jcfg, tcfg = jget_config(ARCH), tget_config(ARCH)
    m = jcfg.moe
    want = max(int(m.capacity_factor * n_tokens * m.top_k / m.n_experts), 1)
    want = -(-want // 8) * 8
    assert tmoe.capacity(tcfg, n_tokens) == want
    assert n_tokens != 1024 or want == 80


def _moe_params(jcfg, tcfg, seed):
    jp = jmoe.moe_init(jax.random.key(seed), jcfg)
    tp = convert._tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


@pytest.mark.parametrize("dtype,factor", [("float32", 1.25),
                                          ("float32", 0.5),
                                          ("bfloat16", 1.25)])
def test_moe_ffn_matches_jax(dtype, factor):
    """Output and aux loss; capacity factor 0.5 drops assignments."""
    jcfg, tcfg = configs(dtype, capacity_factor=factor)
    jp, tp = _moe_params(jcfg, tcfg, 0)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(
        jp, jnp.asarray(x, getattr(jnp, dtype)), jcfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                            tcfg)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == jy.shape
    close(jy, ty, dtype)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_ffn_bf16_keeps_the_expert_products_f32(seed):
    """In bf16 the outputs equal the reference's in all but 1% of their
    elements, and those differ by at most one bf16 ulp (2**-7 relative).
    Rounding the gate/up product to bf16 before the activation, where
    ``preferred_element_type=F32`` keeps it f32, moves over half of them,
    a quarter by more than an ulp."""
    jcfg, tcfg = configs("bfloat16")
    jp, tp = _moe_params(jcfg, tcfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jy, _ = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(
        jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, _ = tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    want = np.asarray(jy.astype(jnp.float32))
    diff = np.abs(ty.float().numpy() - want)
    assert (diff > 0).sum() <= diff.size // 100
    assert (diff <= np.abs(want) * 2.0 ** -7).all()


def test_expert_product_and_its_gradients_match_jax():
    """``_bmm_f32`` on bf16 operands, chunked over more experts than one
    chunk holds, against ``einsum(..., preferred_element_type=F32)``: the
    product in f32 and both gradients as JAX rounds them to bf16."""
    rng = np.random.default_rng(8)
    e = tmoe._CHUNK + 3
    a = rng.standard_normal((e, 5, 16)).astype(np.float32)
    b = rng.standard_normal((e, 16, 12)).astype(np.float32)
    g = rng.standard_normal((e, 5, 12)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    prod = lambda x, y: jnp.einsum(                       # noqa: E731
        "ecd,edf->ecf", x, y, preferred_element_type=jnp.float32)
    jout, vjp = jax.vjp(prod, ja, jb)
    jga, jgb = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).bfloat16().requires_grad_()
    tout = tmoe._bmm_f32(ta, tb)
    tga, tgb = torch.autograd.grad(tout, (ta, tb), torch.from_numpy(g))
    assert tout.dtype == torch.float32
    assert tga.dtype == tgb.dtype == torch.bfloat16
    close(jout, tout.detach())
    close(jga, tga, "bfloat16")
    close(jgb, tgb, "bfloat16")


def test_moe_ffn_with_a_shared_expert_matches_jax():
    jcfg, tcfg = configs(n_shared=1, shared_d_ff=32)
    jp, tp = _moe_params(jcfg, tcfg, 2)
    assert "shared" in tp
    x = np.random.default_rng(3).standard_normal(
        (1, 20, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    close(jy, ty)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_and_decode_match_jax(dtype):
    jcfg, tcfg = configs(dtype)
    jparams, tparams = carried(jcfg, tcfg, 4)
    assert tparams["segments"][0][0]["b0"]["moe"]["wiu"].shape == \
        tuple(jparams["segments"][0]["b0"]["moe"]["wiu"].shape[1:])
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    tl, tcache = ttf.forward_prefill(tparams, tcfg, torch.from_numpy(toks))
    close(jl, tl, dtype)
    _close_caches(jcache, tcache, dtype)
    jcache = jtf.pad_cache(jcache, jcfg, 15)
    tcache = ttf.pad_cache(tcache, tcfg, 15)
    for ctx in (12, 13, 14):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close(jl, tl, dtype)
        _close_caches(jcache, tcache, dtype)


def test_moe_forward_train_and_train_step_match_jax():
    """forward_train's aux (the sum over layers), then one train step:
    loss, parameters (router and experts included) and moments."""
    jcfg, tcfg = configs()
    jparams, tparams = carried(jcfg, tcfg, 6)
    jb, tb = batch(jcfg, 2, 16, 7)
    jl, jaux = jax.jit(jtf.forward_train, static_argnums=(1,))(
        jparams, jcfg, jb["tokens"])
    tl, taux = ttf.forward_train(tparams, tcfg, tb["tokens"])
    close(jl, tl)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    opt = dict(warmup_steps=2, total_steps=10)
    jparams, jopt, jm = jax.jit(jmodel.make_train_step(
        jcfg, jadamw.AdamWConfig(**opt)))(jparams, jadamw.init(jparams), jb)
    tparams, topt, tm = tmodel.make_train_step(
        tcfg, tadamw.AdamWConfig(**opt))(tparams, tadamw.init(tparams), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert topt.m["segments"][0][0]["b0"]["moe"]["router"].dtype == \
        torch.float32
    close_trees(jparams, tparams, **GRAD_TOL)
    close_trees(jopt.m, topt.m, **GRAD_TOL)
    close_trees(jopt.v, topt.v, **GRAD_TOL)
