"""The port's recurrent block kinds against the JAX package, on the CPU at
smoke size: RWKV6 (``models/rwkv.py``, the ``rwkv`` kind of rwkv6-1.6b)
and Griffin's RG-LRU (``models/rglru.py``, the ``rec`` kind of
recurrentgemma-9b), module by module and as whole models (prefill with
caches, teacher-forced decode, ``forward_train`` loss and gradients), then
``serve.run`` and ``train.run`` against the reference's loops.

Inputs come from numpy seeds; weights are the JAX ``init_params`` tree
carried over with :func:`repro_torch.convert.model_params`.  In float32
its constant-initialised f32 leaves (mixing coefficients, the bonus u,
the decay base w0, gate biases, lambda, norm scales) get unit noise so
that they matter; bfloat16 runs at the reference's own init, since with
that noise (norm scales up to ~3) the two packages' bf16 roundings drift
past the bf16 tolerance (0.086 on logits of magnitude 3.6, 5 bf16 ulps)
while the same weights agree within 1e-5 in float32.
Tolerances are those of ``test_torch_models`` and ``test_torch_train``:
rtol = atol = 1e-5 in float32, rtol 2e-2 / atol 6e-2 in bfloat16,
gradients rtol 1e-4 / atol 1e-5 in float32, with one change, by name
(:func:`close_scaled`): where a tensor's entries are sums over time steps
— the WKV state ``S`` (entries up to ~20 here), and in bfloat16 the
whole models' logits, caches and gradients, whose recurrences carry each
bf16 rounding on to later steps — atol is the dtype's atol times
max(1, max |reference|), a few ulps of the tensor's largest entry.  The
measured need: the port's bf16 gradient of rwkv's u (largest entry 136,
where the per-head norm's gain reaches 1/sqrt(eps) on a near-zero first
output) differs from the reference's bf16 one by 1.10, while the
reference's own bf16 and f32 gradients differ by 1.63.  The RG-LRU scan
needs no looser one:
the port runs ``jax.lax.associative_scan``'s recursion, the same combines
in the same order.  The port's chunked WKV against its own step scan is
held to rtol 1e-4 / atol 1e-5, the bound the JAX package sets for the
same comparison (``tests/test_models.py::test_rwkv_chunked_matches_scan``):
the chunked form divides by running decay products.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch import tree as ttree
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttf

from test_torch_models import TOL, close, f32, jdecode, jprefill
from test_torch_serve import _reference_loop
from test_torch_train import (GRAD_TOL, _reference_loop as _train_loop,
                              _without_dt, batch, close_trees, configs,
                              jleaf)

RWKV, REC = "rwkv6-1.6b", "recurrentgemma-9b"
# the reference's functions compiled once per configuration and shape
# (eagerly, every small operation compiles on its own)
jinit = jax.jit(jtf.init_params, static_argnums=(0,))
jtimemix = jax.jit(jrwkv.timemix, static_argnums=(4,))
jscan = jax.jit(jrglru.rglru_scan)
jconv = jax.jit(jrglru._causal_conv)
jblock = jax.jit(jrglru.recurrent_block, static_argnums=(3,))
jblock_step = jax.jit(jrglru.recurrent_block_step, static_argnums=(3,))


def perturbed(jparams, seed: int):
    """`jparams` with unit noise on every f32 leaf that its init fills with
    one constant.  (At a tenth of that scale the bonus u leaves some
    first-token WKV outputs near 0, where the per-head RMS norm divides
    by sqrt(var + eps) and amplifies rounding into the gradients.)"""
    rng = np.random.default_rng(seed)

    def noisy(a):
        x = np.asarray(a)
        if x.dtype == np.float32 and x.size and np.all(x == x.flat[0]):
            return jnp.asarray(x + rng.standard_normal(x.shape)
                               .astype(np.float32))
        return a
    return jax.tree_util.tree_map(noisy, jparams)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str, seed: int):
    jcfg, _ = configs(arch, dtype)
    jparams = jinit(jcfg, jax.random.key(seed))
    return perturbed(jparams, seed) if dtype == "float32" else jparams


def models(arch: str, dtype: str = "float32", seed: int = 1):
    """Both configs and both parameter trees (the port's a fresh copy:
    training updates it in place)."""
    jcfg, tcfg = configs(arch, dtype)
    jparams = _jax_params(arch, dtype, seed)
    tparams = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def block(jparams, tparams, name: str, seg: int = 0, period: int = 0,
          b: str = "b0"):
    """One block's `name` subtree on both sides."""
    jp = jax.tree_util.tree_map(lambda a: a[period],
                                jparams["segments"][seg][b][name])
    return jp, tparams["segments"][seg][period][b][name]


def inputs(rng, shape, dtype: str, scale: float = 1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close_scaled(want, got, dtype: str, err_msg=""):
    """`close` with atol scaled to the reference tensor's largest entry:
    atol x max(1, max|want|)."""
    want, got = f32(want), f32(got)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], err_msg=str(err_msg),
        atol=tol["atol"] * max(1.0, float(np.abs(want).max(initial=0))))


def close_logits(want, got, dtype: str):
    (close_scaled if dtype == "bfloat16" else close)(want, got, dtype)


def close_grads(jgrads, tgrads, dtype: str):
    if dtype == "float32":
        close_trees(jgrads, tgrads, **GRAD_TOL)
        return
    for path, leaf in ttree.leaves_with_path(tgrads):
        close_scaled(jleaf(jgrads, path), leaf, dtype, path)


def close_caches(jcaches, tcaches, dtype: str):
    """Every leaf of every cache entry: the port's periods stacked against
    the reference's stacked leaf (``S``, and every leaf in bfloat16, by
    :func:`close_scaled`)."""
    assert len(jcaches) == len(tcaches)
    for jseg, tseg in zip(jcaches, tcaches):
        for b, entry in jseg.items():
            assert set(entry) == set(tseg[0][b])
            for name, want in entry.items():
                got = torch.stack([p[b][name] for p in tseg])
                assert got.shape == want.shape, (b, name)
                assert got.dtype == getattr(torch, str(want.dtype)), name
                if name == "S" or dtype == "bfloat16":
                    close_scaled(want, got, dtype, name)
                else:
                    close(want, got, dtype)


# ---------------------------------------------------------------------------
# RWKV6 modules
# ---------------------------------------------------------------------------
def _timemix_case(t: int, seed: int, chunk=None):
    jcfg, tcfg, jparams, tparams = models(RWKV)
    if chunk is not None:
        jcfg = dataclasses.replace(jcfg, rwkv_chunk=chunk)
        tcfg = dataclasses.replace(tcfg, rwkv_chunk=chunk)
    jp, tp = block(jparams, tparams, "tm")
    rng = np.random.default_rng(seed)
    h = tcfg.d_model // tcfg.rwkv_head_dim
    hd = tcfg.rwkv_head_dim
    x = inputs(rng, (2, t, tcfg.d_model), "float32", 0.5)
    shift = inputs(rng, (2, tcfg.d_model), "float32", 0.5)
    s0 = inputs(rng, (2, h, hd, hd), "float32", 0.1)
    return jcfg, tcfg, jp, tp, x, shift, s0


@pytest.mark.parametrize("t", [48, 70, 128])
def test_timemix_matches_jax(t, monkeypatch):
    """48 and 70 tokens take the step scan (70 > rwkv_chunk = 64 but no
    multiple of it), 128 the chunked form, on both sides."""
    jcfg, tcfg, jp, tp, x, shift, s0 = _timemix_case(t, t)
    calls = []
    chunked = trwkv._wkv_chunked
    monkeypatch.setattr(trwkv, "_wkv_chunked",
                        lambda *a: calls.append(1) or chunked(*a))
    want = jtimemix(jp, x[0], shift[0], s0[0], jcfg)
    got = trwkv.timemix(tp, x[1], shift[1], s0[1], tcfg)
    assert len(calls) == (t == 128)
    assert got[2].dtype == torch.float32
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        close(w, g)


def test_chunked_wkv_equals_the_step_scan():
    """The port's chunked form against its own step scan (128 tokens,
    chunks of 64, 32 and 16)."""
    _, tcfg, _, tp, x, shift, s0 = _timemix_case(128, 5, chunk=0)
    y0, _, s_0 = trwkv.timemix(tp, x[1], shift[1], s0[1], tcfg)
    for chunk in (64, 32, 16):
        cfg = dataclasses.replace(tcfg, rwkv_chunk=chunk)
        y, _, s = trwkv.timemix(tp, x[1], shift[1], s0[1], cfg)
        torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(s, s_0, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channelmix_matches_jax(dtype):
    jcfg, tcfg, jparams, tparams = models(RWKV, dtype)
    jp, tp = block(jparams, tparams, "cm", period=1)
    rng = np.random.default_rng(2)
    x = inputs(rng, (2, 9, tcfg.d_model), dtype)
    shift = inputs(rng, (2, tcfg.d_model), dtype)
    want = jrwkv.channelmix(jp, x[0], shift[0])
    got = trwkv.channelmix(tp, x[1], shift[1])
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, dtype)
        close(w, g, dtype)


def test_rwkv_state_init_matches_jax():
    jcfg, tcfg = configs(RWKV, "bfloat16")
    want = jrwkv.rwkv_state_init(jcfg, 3)
    got = trwkv.rwkv_state_init(tcfg, 3)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        assert got[name].dtype == getattr(torch, str(w.dtype))
        assert not got[name].any()


# ---------------------------------------------------------------------------
# RG-LRU modules
# ---------------------------------------------------------------------------
def _rec_case(seed: int):
    jcfg, tcfg, jparams, tparams = models(REC)
    jp, tp = block(jparams, tparams, "rec")
    return jcfg, tcfg, jp, tp, np.random.default_rng(seed)


def test_causal_conv_with_history_matches_jax():
    jcfg, tcfg, jp, tp, rng = _rec_case(3)
    w = tcfg.lru_width
    x = inputs(rng, (2, 10, w), "float32")
    hist = inputs(rng, (2, tcfg.conv_width - 1, w), "float32")
    want = jconv(x[0], jp["conv_w"], jp["conv_b"], hist[0])
    got = trglru._causal_conv(x[1], tp["conv_w"], tp["conv_b"], hist[1])
    for a, b in zip(want, got):
        assert tuple(b.shape) == a.shape
        close(a, b)
    # the new history is the last cw - 1 rows of (hist, x)
    assert torch.equal(got[1], x[1][:, -(tcfg.conv_width - 1):])


@pytest.mark.parametrize("t", [1, 37, 64])
def test_rglru_scan_with_h0_matches_jax(t):
    """Odd and even lengths through the scan's recursion, from a non-zero
    h0; also against a plain loop of steps in the port."""
    jcfg, tcfg, jp, tp, rng = _rec_case(t)
    u = inputs(rng, (2, t, tcfg.lru_width), "float32")
    h0 = inputs(rng, (2, tcfg.lru_width), "float32")
    want = jscan(jp, u[0], h0[0])
    got = trglru.rglru_scan(tp, u[1], h0[1])
    for a, b in zip(want, got):
        close(a, b)
    h, steps = h0[1], []
    for i in range(t):
        _, h = trglru.rglru_step(tp, u[1][:, i], h)
        steps.append(h)
    torch.testing.assert_close(got[0], torch.stack(steps, dim=1),
                               rtol=1e-5, atol=1e-5)


def test_rglru_step_matches_jax():
    jcfg, tcfg, jp, tp, rng = _rec_case(4)
    u = inputs(rng, (3, tcfg.lru_width), "float32")
    h = inputs(rng, (3, tcfg.lru_width), "float32")
    for a, b in zip(jrglru.rglru_step(jp, u[0], h[0]),
                    trglru.rglru_step(tp, u[1], h[1])):
        close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block_and_step_match_jax(dtype):
    """The block over 11 tokens from a non-zero state, then one decode
    step from the state it returns."""
    jcfg, tcfg, jparams, tparams = models(REC, dtype)
    jp, tp = block(jparams, tparams, "rec", b="b1")
    rng = np.random.default_rng(5)
    w = tcfg.lru_width
    x = inputs(rng, (2, 11, tcfg.d_model), dtype)
    h0 = inputs(rng, (2, w), "float32")
    conv = inputs(rng, (2, tcfg.conv_width - 1, w), dtype)
    jy, jst = jblock(jp, x[0], {"h": h0[0], "conv": conv[0]}, jcfg)
    ty, tst = trglru.recurrent_block(tp, x[1], {"h": h0[1], "conv": conv[1]},
                                     tcfg)
    close(jy, ty, dtype)
    for name in ("h", "conv"):
        assert tst[name].dtype == getattr(torch, str(jst[name].dtype))
        close(jst[name], tst[name], dtype)
    x1 = inputs(rng, (2, 1, tcfg.d_model), dtype)
    jy, jst = jblock_step(jp, x1[0], jst, jcfg)
    ty, tst = trglru.recurrent_block_step(tp, x1[1], tst, tcfg)
    close(jy, ty, dtype)
    for name in ("h", "conv"):
        close(jst[name], tst[name], dtype)


@pytest.mark.parametrize("arch", [RWKV, REC, "deepseek-v3-671b"])
def test_params_map_one_to_one(arch):
    """The port's own init draws the reference's leaves (names, shapes,
    dtypes; the period axis unstacked), bf16 where the reference's are."""
    jcfg, tcfg, _, carried_ = models(arch, "bfloat16")
    mine = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def names(tree, prefix=""):
        if isinstance(tree, dict):
            return {n for k, v in tree.items()
                    for n in names(v, f"{prefix}/{k}")}
        if isinstance(tree, list):
            return names(tree[0], prefix) | {(prefix, len(tree))}
        return {(prefix, tuple(tree.shape), tree.dtype)}
    assert names(mine) == names(carried_)
    assert ttf.n_param_elements(mine) == sum(
        x.size for x in jax.tree_util.tree_leaves(_jax_params(
            arch, "bfloat16", 1)))


@pytest.mark.parametrize("arch", [RWKV, REC, "deepseek-v3-671b"])
def test_segments_at_full_depth_match_jax(arch):
    """The published depths' segments: rwkv's 24 periods of one block,
    recurrentgemma's (rec, rec, attn) x 12 and (rec, rec) x 1, deepseek's
    3 dense layers and 58 MoE layers."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config as tget_config
    want = [(s.pattern, s.n_periods) for s in jtf.segments(jget_config(arch))]
    got = [(s.pattern, s.n_periods) for s in ttf.segments(tget_config(arch))]
    assert got == want
    assert sum(len(p) * n for p, n in got) == tget_config(arch).n_layers


def test_gelu_gate_is_the_tanh_form():
    x = torch.linspace(-4, 4, 33)
    close(jax.nn.gelu(jnp.asarray(x.numpy())), trglru._gelu(x))


# ---------------------------------------------------------------------------
# whole models: prefill, teacher-forced decode, loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [RWKV, REC])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    """20 tokens (past recurrentgemma's smoke window of 16: the rolled
    cache of its attention layer), then 3 decode steps fed the same
    tokens on both sides; every cache leaf compared."""
    jcfg, tcfg, jparams, tparams = models(arch, dtype)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    tl, tcache = ttf.forward_prefill(tparams, tcfg, torch.from_numpy(toks))
    close_logits(jl, tl, dtype)
    close_caches(jcache, tcache, dtype)
    jcache = jtf.pad_cache(jcache, jcfg, 24)
    tcache = ttf.pad_cache(tcache, tcfg, 24)
    for ctx in range(20, 23):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close_logits(jl, tl, dtype)
        close_caches(jcache, tcache, dtype)


@pytest.mark.parametrize("arch,n,pad", [(RWKV, 20, 24), (REC, 20, 24),
                                        ("deepseek-v3-671b", 12, 15)])
def test_decode_from_a_carried_cache_matches_jax(arch, n, pad):
    """The JAX package's own padded caches (WKV states and shifts, RG-LRU
    states and conv history, MLA's latent), carried over with
    ``convert.dense_cache``, decode as the reference does (the shapes of
    the prefill-and-decode tests, whose compiled functions it reuses)."""
    jcfg, tcfg, jparams, tparams = models(arch)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, (2, n)).astype(np.int32)
    _, jcache = jprefill(jparams, jcfg, jnp.asarray(toks))
    jcache = jtf.pad_cache(jcache, jcfg, pad)
    tcache = convert.dense_cache(jax.tree_util.tree_map(np.asarray, jcache),
                                 device="cpu")
    close_caches(jcache, tcache, "float32")
    for ctx in (n, n + 1):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(ctx))
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, ctx)
        close(jl, tl)
        close_caches(jcache, tcache, "float32")


@pytest.mark.parametrize("arch,seq", [(RWKV, 20), (RWKV, 128), (REC, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(arch, seq, dtype):
    """`value_and_grad` against ``jax.value_and_grad`` of the reference's
    loss; rwkv at 128 tokens takes the chunked WKV (rwkv_chunk = 64)."""
    jcfg, tcfg, jparams, tparams = models(arch, dtype)
    jb, tb = batch(jcfg, 2, seq, 8)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, jcfg, bt)[0]))(jparams, jb)
    tloss, tgrads = tmodel.value_and_grad(tparams, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=TOL[dtype]["rtol"])
    close_grads(jgrads, tgrads, dtype)
    for path, g in ttree.leaves_with_path(tgrads):
        p = tparams
        for k in path:
            p = p[k]
        assert g.dtype == p.dtype and g.shape == p.shape, path


@pytest.mark.parametrize("arch", [RWKV, REC])
def test_adamw_update_decays_the_new_leaves_as_jax(arch):
    """Two AdamW updates of the smoke model's parameters (rwkv's u (H, hd),
    mix_b (5, 32, d) and mixing vectors; rec's conv_w (cw, W) and the
    (W,) biases and lambda; the norm scales under ``segments``) from the
    reference's own gradients: parameters and moments as the reference's
    update, whose decay goes by the stacked leaf's rank."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    jcfg, tcfg, jparams, tparams = models(arch)
    jb, _ = batch(jcfg, 2, 16, 9)
    jgrads = jax.jit(jax.grad(
        lambda p, bt: jmodel.loss_fn(p, jcfg, bt)[0]))(jparams, jb)
    tgrads = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    opt = dict(lr=0.05, warmup_steps=1, total_steps=4)
    jupdate = jax.jit(functools.partial(jadamw.update,
                                        jadamw.AdamWConfig(**opt)))
    jstate, tstate = jadamw.init(jparams), tadamw.init(tparams)
    for _ in range(2):
        jparams, jstate, jm = jupdate(jgrads, jstate, jparams)
        tparams, tstate, tm = tadamw.update(tadamw.AdamWConfig(**opt),
                                            tgrads, tstate, tparams)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    close_trees(jparams, tparams, **GRAD_TOL)
    close_trees(jstate.m, tstate.m, **GRAD_TOL)
    close_trees(jstate.v, tstate.v, **GRAD_TOL)
    # vectors under segments are decayed (rank 2 stacked), final_norm not
    mixer = "tm" if arch == RWKV else "rec"
    leaf = "w0" if arch == RWKV else "bi"
    assert tadamw._decayed(("segments", 0, 0, "b0", mixer, leaf),
                           tparams["segments"][0][0]["b0"][mixer][leaf])
    assert not tadamw._decayed(("final_norm", "scale"),
                               tparams["final_norm"]["scale"])


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def reference_tokens(seen, requests: int):
    """The reference loop's decoded tokens as ``serve.run`` returns them."""
    toks = seen["tokens"]
    return {sid: toks[sid::requests] for sid in range(requests)}


@pytest.mark.parametrize("arch", [RWKV, REC])
def test_serve_run_matches_reference_loop(monkeypatch, capsys, arch):
    """`serve.run` against ``repro.launch.serve.main`` (the jnp oracle for
    K4, as test_torch_serve): the first block keeps no K/V, so the pool
    holds only the decode steps' zero rows; tokens and KVStats equal."""
    shape = dict(requests=3, prefill=20, decode=3, page_size=4, hbm_pages=5)
    jcfg, tcfg = configs(arch)
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in shape.items()]
    calls, seen = _reference_loop(monkeypatch, jcfg, argv)
    capsys.readouterr()
    params = convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, seen["params"]),
        device="cpu")
    tops.reset_launches()
    got = tserve.run(tcfg, device="cpu", params=params, **shape)
    assert tops.LAUNCHES["paged_attention_ref"] == shape["decode"]
    jkv = seen["kv"]
    assert got["kv_stats"] == dataclasses.asdict(jkv.stats)
    assert got["tier_histogram"] == jkv.tier_histogram()
    assert got["kv"].block_tables == jkv.block_tables
    assert got["tokens"] == reference_tokens(seen, shape["requests"])
    assert len(calls) == len(got["attn_out"]) == shape["decode"]
    for (args, want), out in zip(calls, got["attn_out"]):
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    q, kp, _, bt, cl = got["last_attn_inputs"]
    assert np.array_equal(q.numpy(), calls[-1][0][0])
    assert np.array_equal(cl.numpy(), calls[-1][0][4])
    assert not kp.any() and got["logits_finite"]


def test_rwkv_train_run_matches_the_reference_loop(tmp_path):
    """`train.run` on rwkv smoke (5 steps, a failure at step 3, a
    checkpoint every 2) against the reference's loop: the log, the
    parameters and the second moments."""
    jcfg, tcfg, jparams, tparams = models(RWKV)
    kw = dict(steps=5, seq=16, fail_at=3, ckpt_every=2)
    jrt, (jp, jopt) = _train_loop(jcfg, jparams, batch_=2, accum=1,
                                  ckpt_dir=tmp_path / "j", **kw)
    r = ttrain.run(tcfg, batch=2, log_every=0, ckpt_dir=str(tmp_path / "t"),
                   device="cpu", params=tparams, **kw)
    assert r["restarts"] == jrt.restarts == 1
    tlog, jlog = _without_dt(r["log"]), _without_dt(jrt.log)
    assert [e["event"] for e in tlog] == [e["event"] for e in jlog]
    for te, je in zip(tlog, jlog):
        for k in je:
            if k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(te[k], je[k], rtol=1e-4)
            else:
                assert te[k] == je[k], k
    tp, topt = r["state"]
    close_trees(jp, tp, **GRAD_TOL)
    close_trees(jopt.v, topt.v, **GRAD_TOL)
