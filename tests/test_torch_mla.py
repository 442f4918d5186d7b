"""The port's multi-head latent attention (MLA, ``attn_kind == "mla"``)
and the deepseek-v3-671b stack around it, against the JAX package on the
CPU at smoke size: ``mla_attention``, ``mla_prefill`` and ``mla_decode``,
then the whole model (prefill with its latent caches, teacher-forced
decode, ``forward_train`` loss and gradients) and ``serve.run`` against
the reference's loop.

Weights are the JAX ``init_params`` tree (its norm scales given unit noise
in float32) carried over with :func:`repro_torch.convert.model_params`;
tolerances and the scale-relative bf16 comparison are those of
``test_torch_recurrent`` (rtol = atol = 1e-5 in float32, gradients rtol
1e-4 / atol 1e-5).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf

from test_torch_models import TOL, close, jdecode, jprefill
from test_torch_recurrent import (block, close_caches, close_grads,
                                  close_logits, inputs, models,
                                  reference_tokens)
from test_torch_serve import _reference_loop
from test_torch_train import batch, configs

MLA = "deepseek-v3-671b"
def load_by_path(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "test_torch_mla_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the benchmark's dense reference: the serving loop's pool accounting
DENSE_REF = load_by_path(pathlib.Path(__file__).resolve().parents[1]
                         / "bench" / "reference" / "dense_lm.py")
jmla = jax.jit(jattn.mla_attention, static_argnums=(2,))
jmla_prefill = jax.jit(jattn.mla_prefill, static_argnums=(2,))
jmla_decode = jax.jit(jattn.mla_decode, static_argnums=(2,))


def _case(s: int, seed: int):
    jcfg, tcfg, jparams, tparams = models(MLA)
    jp, tp = block(jparams, tparams, "attn")
    rng = np.random.default_rng(seed)
    x = inputs(rng, (2, s, tcfg.d_model), "float32")
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    return jcfg, tcfg, jp, tp, x, (jnp.asarray(pos), torch.from_numpy(pos))


def test_mla_attention_matches_jax():
    """Training's form: q/k of nope + rope = 24, v of 16 (smoke), in one
    KV chunk (blockwise_attention's default); scaled by q's width."""
    jcfg, tcfg, jp, tp, x, pos = _case(20, 1)
    want = jmla(jp, x[0], jcfg, pos[0])
    got = tattn.mla_attention(tp, x[1], tcfg, pos[1])
    assert tuple(got.shape) == want.shape
    close(want, got)


def test_mla_prefill_matches_jax():
    """Prefill's form: 40 tokens in KV chunks of cfg.kv_chunk = 32 (a
    padded tail chunk), and the latent cache."""
    jcfg, tcfg, jp, tp, x, pos = _case(40, 2)
    assert tcfg.kv_chunk == 32
    jy, jc = jmla_prefill(jp, x[0], jcfg, pos[0])
    ty, tc = tattn.mla_prefill(tp, x[1], tcfg, pos[1])
    close(jy, ty)
    for name in ("ckv", "krope"):
        assert tuple(tc[name].shape) == jc[name].shape
        close(jc[name], tc[name])
    # the attention without a cache is the same computation
    close(ty, tattn.mla_attention(tp, x[1], tcfg, pos[1]))


@pytest.mark.parametrize("ctx", [7, 33])
def test_mla_decode_matches_jax(ctx):
    """The absorbed decode after a `ctx`-token prefill, into a cache padded
    to ctx + 3, two steps."""
    jcfg, tcfg, jp, tp, x, pos = _case(ctx, ctx)
    _, jc = jmla_prefill(jp, x[0], jcfg, pos[0])
    _, tc = tattn.mla_prefill(tp, x[1], tcfg, pos[1])
    pad = ((0, 0), (0, 3), (0, 0))
    jc = {k: jnp.pad(v, pad) for k, v in jc.items()}
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, 3)) for k, v in tc.items()}
    rng = np.random.default_rng(ctx + 100)
    for step in range(2):
        x1 = inputs(rng, (2, 1, tcfg.d_model), "float32")
        jy, jc = jmla_decode(jp, x1[0], jcfg, jc, jnp.int32(ctx + step))
        ty, tc = tattn.mla_decode(tp, x1[1], tcfg, tc, ctx + step)
        assert tuple(ty.shape) == jy.shape
        close(jy, ty)
        for name in ("ckv", "krope"):
            close(jc[name], tc[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_prefill_and_decode_match_jax(dtype):
    """The smoke stack: one dense MLA layer, then two MoE layers with MLA;
    12 tokens, a cache padded to 15, three decode steps."""
    jcfg, tcfg, jparams, tparams = models(MLA, dtype)
    assert [len(seg) for seg in tparams["segments"]] == [1, 2]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    tl, tcache = ttf.forward_prefill(tparams, tcfg, torch.from_numpy(toks))
    close_logits(jl, tl, dtype)
    close_caches(jcache, tcache, dtype)
    jcache = jtf.pad_cache(jcache, jcfg, 15)
    tcache = ttf.pad_cache(tcache, tcfg, 15)
    assert tcache[1][0]["b0"]["ckv"].shape[1] == 15
    for ctx in (12, 13, 14):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close_logits(jl, tl, dtype)
        close_caches(jcache, tcache, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_loss_and_grads_match_jax(dtype):
    """`value_and_grad` (the MoE aux loss included) against
    ``jax.value_and_grad`` of the reference's loss."""
    jcfg, tcfg, jparams, tparams = models(MLA, dtype)
    jb, tb = batch(jcfg, 2, 20, 6)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, jcfg, bt)[0]))(jparams, jb)
    tloss, tgrads = tmodel.value_and_grad(tparams, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=TOL[dtype]["rtol"])
    close_grads(jgrads, tgrads, dtype)


def test_pad_cache_pads_the_latent_and_never_windows_it():
    """ckv / krope pad to the target even when the config has a window,
    as the reference's pad_cache."""
    jcfg, tcfg = configs(MLA)
    jcfg, tcfg = (dataclasses.replace(c, window=8) for c in (jcfg, tcfg))
    jc = jtf.init_cache(jcfg, 1, 5)
    tc = ttf.init_cache(tcfg, 1, 5, device="cpu")
    jc, tc = jtf.pad_cache(jc, jcfg, 12), ttf.pad_cache(tc, tcfg, 12)
    for jseg, tseg in zip(jc, tc):
        for name in ("ckv", "krope"):
            assert jseg["b0"][name].shape[2] == 12
            assert tseg[0]["b0"][name].shape[1] == 12


def test_serve_run_matches_reference_loop(monkeypatch, capsys):
    """`serve.run` on deepseek smoke against ``repro.launch.serve.main``
    (the jnp oracle for K4): the same tokens and K4 queries.  The
    reference's pool keeps no pages for MLA; the port's holds layer 0's
    normed latent and roped rope key, one row of 16 + 8 a token, from the
    prompts on, so its counters follow the benchmark reference's accounting
    of a pool filled so, its pages priced at that row, and every K4 output
    is the absorbed attention over the rows: scores over the whole row,
    values its first 16 columns."""
    shape = dict(requests=3, prefill=20, decode=3, page_size=4, hbm_pages=5)
    jcfg, tcfg = configs(MLA)
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in shape.items()]
    calls, seen = _reference_loop(monkeypatch, jcfg, argv)
    capsys.readouterr()
    params = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, seen["params"]),
        device="cpu")
    tops.reset_launches()
    got = tserve.run(tcfg, device="cpu", params=params, **shape)
    assert tops.LAUNCHES["paged_attention_ref"] == shape["decode"]
    assert got["tokens"] == reference_tokens(seen, shape["requests"])
    kv = got["kv"]
    rd, wr = (kv.timing.cxl.payload_read_gbps, kv.timing.cxl.payload_write_gbps)
    assert got["kv_stats"] == DENSE_REF.kv_accounting(
        3, 20, 3, 4, 5, 4 * 24 * 2, rd, wr)
    assert kv.v_pool is None and kv.page_bytes() == 4 * 24 * 2
    pool = kv.k_pool[0].float().numpy()
    rng = np.random.default_rng(0)
    for sid in range(shape["requests"]):
        toks = rng.integers(0, tcfg.vocab_size, (1, shape["prefill"]))
        _, cache = ttf.forward_prefill(params, tcfg, torch.from_numpy(
            toks.astype(np.int32)))
        first = cache[0][0]["b0"]
        rows = torch.cat([first["ckv"][0], first["krope"][0]], -1).numpy()
        table = kv.block_tables[sid]
        stashed = np.concatenate([pool[pg, :, 0] for pg in table])
        np.testing.assert_array_equal(stashed[:shape["prefill"]], rows)
        assert not stashed[shape["prefill"]:].any()   # the decode steps'
    scale = (16 + 8) ** -0.5
    for step, ((args, _), out) in enumerate(zip(calls, got["attn_out"])):
        jq = args[0]                    # the same draws as the port's
        for b in range(shape["requests"]):
            rows = np.concatenate([pool[pg, :, 0]
                                   for pg in kv.block_tables[b]])
            rows = rows[:shape["prefill"] + step].astype(np.float64)
            att = jq[b].astype(np.float64) @ rows.T * scale
            att = np.exp(att - att.max(-1, keepdims=True))
            att /= att.sum(-1, keepdims=True)
            np.testing.assert_allclose(out[b].numpy(), att @ rows[:, :16],
                                       rtol=1e-5, atol=1e-5)
    q = got["last_attn_inputs"][0]
    assert np.array_equal(q.numpy(), calls[-1][0][0])
    assert tuple(q.shape) == (3, tcfg.n_heads, 16 + 8)
