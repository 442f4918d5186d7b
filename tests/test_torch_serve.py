"""The port's serving stack against the JAX package's, on the CPU.

* ``PagedKVCache`` and ``ContinuousBatcher`` driven through the same
  scripted sequences: block tables, tier maps, LRU clocks, ``KVStats``
  (integers exact, ``sim_seconds`` to the ulp: compared with ``==``),
  ``tier_histogram`` and ``EngineStats`` equal; pool contents equal in
  float32.
* ``launch.serve.run`` against the reference's own loop
  (``repro.launch.serve.main``, with the JAX oracle
  ``repro.kernels.ref.paged_attention`` standing in for the Pallas kernel,
  which JAX 0.9 cannot run, and jit around its model calls for speed), on
  the same weights: KV stats and histogram equal, block tables and
  context lengths equal at every step, and every step's K4 output within
  rtol = atol = 1e-5 in float32 (the pools agree to that), or atol =
  6e-2, rtol = 2e-2 in bf16, where the prefill's layer-0 keys that fill
  the pool differ by a few bf16 ulps between XLA and PyTorch.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref as jref
from repro.memory.kvcache import PagedKVCache as JCache
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.memory.kvcache import PagedKVCache as TCache
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serving.scheduler import ContinuousBatcher as TBatcher
from repro_torch.serving.scheduler import Request as TRequest

ARCH = "granite-3-8b"


def _caches(n_pages=12, page_size=4, max_blocks=6, budget=3):
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(ARCH), dtype="float32")
    kw = dict(n_pages=n_pages, page_size=page_size, max_blocks=max_blocks,
              hbm_page_budget=budget)
    return jcfg, JCache(jcfg, **kw), TCache(tcfg, device="cpu", **kw)


def _same_state(jkv, tkv):
    assert dataclasses.asdict(tkv.stats) == dataclasses.asdict(jkv.stats)
    assert tkv.tier_histogram() == jkv.tier_histogram()
    assert tkv.block_tables == jkv.block_tables
    assert tkv.seq_lens == jkv.seq_lens
    assert tkv.free == jkv.free and tkv.clock == jkv.clock
    assert np.array_equal(tkv.tier, jkv.tier)
    assert np.array_equal(tkv.last_use, jkv.last_use)
    for layer in range(jkv.n_layers):
        assert np.array_equal(tkv.k_pool[layer].numpy(),
                              np.asarray(jkv.k_pool[layer]))
        assert np.array_equal(tkv.v_pool[layer].numpy(),
                              np.asarray(jkv.v_pool[layer]))


def test_paged_kv_cache_scripted_sequence_matches_jax():
    cfg, jkv, tkv = _caches()
    rng = np.random.default_rng(0)
    kh, hd = cfg.n_kv_heads, cfg.head_dim

    def both(op, *args):
        results = []
        for kv in (jkv, tkv):
            try:
                results.append(("ok", getattr(kv, op)(*args)))
            except (MemoryError, KeyError) as e:
                results.append((type(e).__name__, None))
        assert results[0][0] == results[1][0], (op, args, results)
        return results

    def append(sid, t):
        k = rng.standard_normal((t, kh, hd)).astype(np.float32)
        v = rng.standard_normal((t, kh, hd)).astype(np.float32)
        return both("append_tokens", sid, 0, k, v)

    for sid in range(3):
        both("allocate", sid)
        append(sid, 5 + 2 * sid)             # demotes past 3 HBM pages
    both("allocate", 1)                      # KeyError on both
    for step in range(4):
        (_, jout), (_, tout) = both("gather_args", [0, 1, 2])
        assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())
        assert np.array_equal(np.asarray(jout[1]), tout[1].numpy())
        assert tout[0].dtype == torch.int32 and tout[1].dtype == torch.int32
        for sid in (0, 2):
            append(sid, 1)
        _same_state(jkv, tkv)
    both("release", 1)
    both("allocate", 3)
    statuses = [append(3, 9) for _ in range(3)]   # exhausts the pool
    assert ("MemoryError", None) in [s[0] for s in statuses]
    both("gather_args", [3, 0])
    _same_state(jkv, tkv)
    both("release", 3)
    both("release", 2)
    both("gather_args", [0])                 # HBM room: CXL pages promote
    _same_state(jkv, tkv)
    assert jkv.stats.demotions and jkv.stats.cxl_fetches \
        and jkv.stats.promotions
    assert tkv.page_bytes() == jkv.page_bytes()
    assert tkv.lines_per_page() == jkv.lines_per_page()
    assert np.array_equal(tkv.tier_snapshot(), jkv.tier_snapshot())
    assert tkv.hbm_pages_in_use() == jkv.hbm_pages_in_use()


def _drain(cache_cls, batcher_cls, request_cls, cfg, *, n_pages, page_size,
           max_running, requests, budget, device=None):
    kw = dict(device=device) if device else {}
    kv = cache_cls(cfg, n_pages=n_pages, page_size=page_size,
                   max_blocks=16, hbm_page_budget=budget, **kw)
    eng = batcher_cls(kv, max_running=max_running)
    for rid, (prompt, new) in enumerate(requests):
        eng.submit(request_cls(rid=rid, prompt_len=prompt,
                               max_new_tokens=new))
    log = []

    def zeros(t):
        return np.zeros((t, cfg.n_kv_heads, cfg.head_dim), np.float32)

    def prefill(req):
        kv.append_tokens(req.rid, 0, zeros(req.prompt_len),
                         zeros(req.prompt_len))

    def decode(seq_ids):
        log.append(list(seq_ids))
        bt, cl = kv.gather_args(seq_ids)
        log.append(np.asarray(bt).tolist() + np.asarray(cl).tolist())
        for sid in seq_ids:
            kv.append_tokens(sid, 0, zeros(1), zeros(1))
        return {sid: 1 for sid in seq_ids}

    stats = eng.run_until_drained(prefill, decode, max_steps=500)
    done = [dataclasses.asdict(r) for r in eng.done]
    return (stats.row(), done, eng.ttft(), log,
            dataclasses.asdict(kv.stats), kv.tier_histogram())


@pytest.mark.parametrize("scenario", [
    dict(n_pages=32, page_size=4, max_running=4, budget=32,
         requests=[(6, 4)] * 6),                      # all complete
    dict(n_pages=6, page_size=4, max_running=2, budget=3,
         requests=[(6, 4)] * 4),                      # admission limits
    dict(n_pages=5, page_size=4, max_running=4, budget=2,
         requests=[(4, 12), (4, 12)]),                # preemption
    dict(n_pages=20, page_size=3, max_running=3, budget=4,
         requests=[(5, 7), (9, 3), (2, 11), (7, 5), (4, 4)]),
])
def test_continuous_batcher_matches_jax(scenario):
    jcfg = jget_smoke(ARCH)
    tcfg = tget_smoke(ARCH)
    want = _drain(JCache, JBatcher, JRequest, jcfg, **scenario)
    got = _drain(TCache, TBatcher, TRequest, tcfg, device="cpu", **scenario)
    assert got == want
    # every request completes; a preempted one decodes its tokens again
    assert len(want[1]) == len(scenario["requests"])
    assert want[0]["decoded_tokens"] >= sum(n for _, n in
                                            scenario["requests"])


def _reference_loop(monkeypatch, jcfg, argv):
    """Run ``repro.launch.serve.main`` and record its weights, its cache,
    every paged-attention call (inputs and output) and every decoded
    token."""
    calls, seen = [], {}

    def attention(*args):
        out = jref.paged_attention(*args)
        calls.append(([np.asarray(a) for a in args], np.asarray(out)))
        return out

    init = jax.jit(jserve.tf.init_params, static_argnums=(0,))

    def init_params(cfg, key):
        seen["params"] = init(cfg, key)
        return seen["params"]

    class Recorded(JCache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["kv"] = self

    monkeypatch.setattr(jserve, "get_smoke", lambda arch: jcfg)
    monkeypatch.setattr(jserve.ops, "paged_attention", attention)
    monkeypatch.setattr(jserve, "PagedKVCache", Recorded)
    monkeypatch.setattr(jserve.tf, "init_params", init_params)
    monkeypatch.setattr(jserve.tf, "forward_prefill", jax.jit(
        jserve.tf.forward_prefill, static_argnums=(1,)))
    decode = jax.jit(jserve.tf.decode_step, static_argnums=(1,))

    def decode_step(*args):
        logits, caches = decode(*args)
        # the loop's next token, in its order (step-major, request-minor)
        seen.setdefault("tokens", []).append(int(np.argmax(
            np.asarray(logits[0, 0]))))
        return logits, caches

    monkeypatch.setattr(jserve.tf, "decode_step", decode_step)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    return calls, seen


@pytest.mark.parametrize("dtype,tol", [
    ("float32", dict(rtol=1e-5, atol=1e-5)),
    ("bfloat16", dict(rtol=2e-2, atol=6e-2)),
])
def test_serve_run_matches_reference_loop(monkeypatch, capsys, dtype, tol):
    # small pages and HBM budget force CXL demotions, fetches, promotions
    shape = dict(requests=3, prefill=20, decode=3, page_size=4,
                 hbm_pages=5)
    jcfg = dataclasses.replace(jget_smoke("h2o-danube-3-4b"), dtype=dtype)
    tcfg = dataclasses.replace(tget_smoke("h2o-danube-3-4b"), dtype=dtype)
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
    s = got["kv_stats"]
    assert s["demotions"] and s["cxl_fetches"]      # no release: no room
    assert len(calls) == len(got["attn_out"]) == shape["decode"]
    for (args, want), out in zip(calls, got["attn_out"]):
        np.testing.assert_allclose(out.numpy(), want, **tol)
    q, kp, vp, bt, cl = got["last_attn_inputs"]
    jq, jkp, jvp, jbt, jcl = calls[-1][0]
    assert np.array_equal(q.numpy(), jq)
    assert np.array_equal(bt.numpy(), jbt) and np.array_equal(cl.numpy(), jcl)
    np.testing.assert_allclose(kp.numpy(), jkp, **tol)
    assert got["logits_finite"]
    assert all(len(t) == shape["decode"] for t in got["tokens"].values())
    assert got["n_params"] == sum(x.size for x in jax.tree_util.tree_leaves(
        seen["params"]))


def _expected_pool_rows(cfg, first, n):
    """The pool rows and K4 keywords written out from the cache entries:
    a GQA block's keys as keys and values, MLA's ``[ckv | krope]`` at its
    softmax scale with its latent's value columns, else nothing."""
    if "k" in first:
        return (first["k"][0][:n], first["k"][0][:n]), {}
    if cfg.attn_kind == "mla":
        rows = torch.cat([first["ckv"][0, :n], first["krope"][0, :n]],
                         dim=-1)[:, None]
        return (rows, None), {"scale": tattn.mla_softmax_scale(cfg),
                              "v_dim": cfg.mla.kv_lora_rank}
    return None, {}


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_rows_and_k4_keywords_are_the_attention_s(arch):
    """After a smoke prefill (20 tokens: past a 16-token window), the rows
    `pool_rows` gives and `pool_kernel_kwargs` are the loop's own: GQA's
    layer-0 keys as keys and values (windowed, M-RoPE and MoE alike),
    MLA's ``[ckv | krope]`` as keys at its softmax scale with its latent's
    value columns, nothing for rwkv and rec; the rows fit the pool's row
    and `f32_pools` gives K4 the pools written."""
    cfg = tget_smoke(arch)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = (1, 20) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, shape).astype(np.int32))
    _, cache = ttf.forward_prefill(params, cfg, toks)
    first = ttf.pad_cache(cache, cfg, 24)[0][0]["b0"]
    want_rows, want_kw = _expected_pool_rows(cfg, first, 20)
    rows = tattn.pool_rows(first, 20)
    assert tattn.pool_kernel_kwargs(cfg) == want_kw
    if want_rows is None:
        assert rows is None
        return
    assert len(rows) == 2 and torch.equal(rows[0], want_rows[0])
    assert (rows[1] is None if want_rows[1] is None
            else torch.equal(rows[1], want_rows[1]))
    kv = TCache(cfg, n_pages=8, page_size=4, max_blocks=8,
                hbm_page_budget=8, device="cpu")
    assert tuple(rows[0].shape[1:]) == kv.row()
    kv.allocate(0)
    kv.append_tokens(0, 0, *rows)
    kp, vp = kv.f32_pools(0)
    assert torch.equal(kp, kv.k_pool[0].float())
    assert vp is kp if kv.v_pool is None else torch.equal(
        vp, kv.v_pool[0].float())
    table = kv.block_tables[0]
    for pool, want in zip((kp, vp), rows):
        if want is not None:
            got = torch.cat([pool[pg] for pg in table])[:want.shape[0]]
            assert torch.equal(got, want.float())


def test_serve_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--requests", "2",
                                      "--decode", "2", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "arch=h2o-danube-3-4b requests=2 prefill=48 decode=2" in out
    assert "tok/s on CPU" in out and "kv: allocs=4" in out


#: the port's configuration fields that the JAX package's lacks, with their
#: defaults: YaRN, and the gate and held share of an expert-parallel MoE layer
PORT_ONLY = {"rope_scaling": None}
PORT_ONLY_MOE = {"scoring": "softmax", "n_group": 1, "topk_group": 1,
                 "routed_scale": 1.0, "score_bias": False, "held": None}


def jax_fields(cfg) -> dict:
    """`cfg` as a dict without the port-only fields, which must hold their
    defaults."""
    d = dataclasses.asdict(cfg)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    if d["moe"] is not None:
        assert {k: d["moe"].pop(k) for k in PORT_ONLY_MOE} == PORT_ONLY_MOE
    return d


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-3-8b",
                                  "deepseek-v3-671b", "rwkv6-1.6b"])
def test_memory_planner_matches_jax(arch):
    """`memory.tiering` and `memory.offload`: the same plans, schedules and
    tierers (host float64 arithmetic, compared exactly)."""
    from repro.configs import get_config as jget_config
    from repro.memory import offload as joffload
    from repro.memory import tiering as jtiering
    from repro_torch.configs import get_config as tget_config
    from repro_torch.memory import offload as toffload
    from repro_torch.memory import tiering as ttiering
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert jax_fields(tcfg) == dataclasses.asdict(jcfg)
    assert ttiering.kv_bytes_per_token(tcfg) == \
        jtiering.kv_bytes_per_token(jcfg)
    # the port's default describes its card; the JAX default is its
    # named v5e spec, which the port is held to here
    v5e = ttiering.TPU_V5E
    assert dataclasses.asdict(v5e) == dataclasses.asdict(jtiering.TierSpec())
    for kw in (dict(), dict(n_devices=16, batch=8, context=4096)):
        want = jtiering.plan_serving(jcfg, **kw)
        assert dataclasses.asdict(ttiering.plan_serving(
            tcfg, tier=v5e, **kw)) == dataclasses.asdict(want)
    for kw in (dict(), dict(n_devices=16, step_compute_s=0.5)):
        want = jtiering.plan_training(jcfg, **kw)
        got = ttiering.plan_training(tcfg, tier=v5e, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(toffload.schedule(
            got, n_layers=tcfg.n_layers, step_compute_s=0.5)) == \
            dataclasses.asdict(joffload.schedule(
                want, n_layers=jcfg.n_layers, step_compute_s=0.5))
    assert dataclasses.asdict(ttiering.dynamic_tiering(
        v5e, dram_share=0.25, budget=8)) == dataclasses.asdict(
        jtiering.dynamic_tiering(dram_share=0.25, budget=8))


def test_tier_spec_default_describes_the_card():
    """The port's planner defaults to one H100 SXM per host (its data
    sheet's 80 GB of HBM and PCIe Gen5 x16), not the JAX package's v5e."""
    from repro_torch.core import spec as tspec
    from repro_torch.configs import get_config as tget_config
    from repro_torch.memory import tiering as ttiering
    card, v5e = ttiering.TierSpec(), ttiering.TPU_V5E
    assert card.hbm_bytes_per_device == tspec.H100_HBM_BYTES == 80 * 2**30
    assert card.devices_per_host == 1 and card.host_staging_gbps == 64.0
    assert (card.host_dram_bytes, card.cxl_bytes) == (v5e.host_dram_bytes,
                                                      v5e.cxl_bytes)
    assert card.dram_pages == v5e.dram_pages
    # danube's weights (7.9 GB) and a 16 x 32k-token KV cache on one card:
    # the v5e's 14.4 GiB budget spills KV to CXL, the card's 72 GiB less
    cfg = tget_config("h2o-danube-3-4b")
    kw = dict(n_devices=1, batch=16, context=32768)
    on_card = ttiering.plan_serving(cfg, **kw)
    on_v5e = ttiering.plan_serving(cfg, tier=v5e, **kw)
    assert on_card.hbm_bytes > on_v5e.hbm_bytes
    assert on_card.cxl_bytes < on_v5e.cxl_bytes
