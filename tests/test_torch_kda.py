"""Kimi-Linear's serving path (KDA layers beside MLA layers without a query
LoRA or rotary, a pool of latent pages beside resident state slots), on
the CPU at
smoke size, against the benchmark's plain reference
(``bench/reference/kda_mla_moe_lm.py``, loaded by path):

* the program's chunkwise KDA equals its recurrent steps, and the
  reference's chunkwise form the step-by-step recurrence, over ragged
  lengths, carried states and strong decays;
* prefill, then decoding through the cache, gives the reference's
  full-forward logits, in float32;
* the state after a prefill equals the state after stepping token by
  token;
* the 32 EP32 shares' held parts, with the shared expert once, sum to the
  uncut layer;
* the segments and each layer's configuration reproduce Kimi's 27 layer
  kinds;
* the state kind: its slot at the published widths and its counters,
  exact;
* MLA without a query LoRA or rotary, its prefill through K5's dispatch
  at the plain softmax scale, DeepSeek-V3's under YaRN on the loop.
"""
import dataclasses
import math
import pathlib
import sys

import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.memory.kvcache import pool_kinds
from repro_torch.models import kda as tkda
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import mlp

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:       # the benchmark's harness, as it runs
    sys.path.append(str(BENCH))

from harness.core import Cell, load_module  # noqa: E402

REF = load_module(BENCH / "reference" / "kda_mla_moe_lm.py", "test_kda_ref_")
GEN = load_module(BENCH / "generators" / "serve_kda_mla_moe.py",
                  "test_kda_gen_")
CELLS = load_module(BENCH / "tests" / "bench_kda_cells.py",
                    "test_kda_cells_")
CPU = torch.device("cpu")


def _recurrence_inputs(t, h, dk, dv, seed):
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen)
    q = torch.nn.functional.normalize(normal(2, t, h, dk), dim=-1) * dk ** -0.5
    k = torch.nn.functional.normalize(normal(2, t, h, dk), dim=-1)
    # decays up to 6 a step: 384 over a chunk of 64, far past exp's range
    g = -6.0 * torch.rand((2, t, h, dk), generator=gen)
    beta = torch.rand((2, t, h), generator=gen)
    return q, k, normal(2, t, h, dv), g, beta, normal(2, h, dk, dv)


@pytest.mark.parametrize("t,chunk", [(37, 8), (64, 16), (130, 64)])
def test_chunkwise_kda_equals_its_recurrent_steps(t, chunk):
    """The program's chunk_scan (a ragged tail, the state carried between
    chunks, a nonzero state to start from) against recurrent_step token by
    token: outputs and final state within 1e-5; the reference's kda_scan
    against its kda_recurrent alike."""
    q, k, v, g, beta, s0 = _recurrence_inputs(t, 3, 16, 8, t)
    o, s = tkda.chunk_scan(q, k, v, g, beta, chunk, s0.clone())
    state = s0.clone()
    want = torch.stack([tkda.recurrent_step(q[:, i], k[:, i], v[:, i],
                                            g[:, i], beta[:, i], state)
                        for i in range(t)], dim=1)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, state, rtol=1e-5, atol=1e-5)
    ro, rs = REF.kda_scan(q[0], k[0], v[0], g[0], beta[0], chunk, s0[0])
    wo, ws = REF.kda_recurrent(q[0], k[0], v[0], g[0], beta[0], s0[0])
    torch.testing.assert_close(ro, wo, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, ws, rtol=1e-5, atol=1e-5)


def _f32_model():
    """The small cell's model in float32: its configuration, the program's
    config, the reference's weights and the program's tree of them."""
    m = CELLS.small_kda_cell().config
    w = REF.make_params(m, 11, CPU, 0.1)
    return m, GEN.program_config(m), w, GEN.program_params(m, w)


def test_prefill_then_decode_gives_the_reference_logits():
    """A 20-token prefill (chunks of 8: two full and a ragged one), then 6
    tokens decoded through the cache (KDA states and windows, MLA
    latents), in float32: every logit within 2e-5 of the reference's full
    forward at the same positions."""
    m, cfg, w, params = _f32_model()
    toks = torch.randint(0, m["vocab_size"], (26,),
                         generator=torch.Generator().manual_seed(5))
    want = REF.forward(m, w, toks, range(19, 26))
    logits, cache = ttf.forward_prefill(params, cfg, toks[None, :20])
    cache = ttf.pad_cache(cache, cfg, 26)
    got = [logits[0, -1]]
    for i in range(20, 26):
        step, cache = ttf.decode_step(params, cfg, toks[i:i + 1], cache, i)
        got.append(step[0, 0])
    torch.testing.assert_close(torch.stack(got), want, rtol=0, atol=2e-5)


def test_state_after_prefill_equals_stepping_token_by_token():
    """Layer 0's KDA cache after a 20-token prefill equals a 1-token
    prefill's updated in place by 19 decode steps; and the reference's
    state of the same tokens."""
    m, cfg, w, params = _f32_model()
    toks = torch.randint(0, m["vocab_size"], (1, 20),
                         generator=torch.Generator().manual_seed(6))
    _, whole = ttf.forward_prefill(params, cfg, toks)
    _, cache = ttf.forward_prefill(params, cfg, toks[:, :1])
    cache = ttf.pad_cache(cache, cfg, 20)
    for i in range(1, 20):
        _, cache = ttf.decode_step(params, cfg, toks[:, i], cache, i)
    want = REF.layer_state(m, w, toks[0])
    for got in (ttf.layer_entry(whole, cfg, 0),
                ttf.layer_entry(cache, cfg, 0)):
        torch.testing.assert_close(got["S"][0], want["S"], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got["conv"][0], want["conv"], rtol=1e-5,
                                   atol=1e-5)


def test_the_ep32_shares_sum_to_the_uncut_layer():
    """Kimi's gate over 64 experts (top 8, one group, scale 2.446, a
    bias) at smoke widths in float32: the 32 shares of 2 held experts
    each, their shared expert left out, plus the shared expert once,
    equal the reference's layer holding all 64 experts."""
    cfg = get_smoke("kimi-linear-48b-a3b")
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, n_experts=64, top_k=8))
    gen = torch.Generator().manual_seed(9)
    p = tmoe.moe_init(gen, cfg)
    p["bias"] = 0.2 * torch.randn(64, generator=gen)
    x = torch.randn((1, 12, cfg.d_model), generator=gen)
    shares = torch.zeros_like(x)
    for rank in range(32):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, held=(2 * rank, 2)))
        held = {k: v for k, v in p.items() if k != "shared"}
        held["wiu"], held["wo"] = (p[k][2 * rank:2 * rank + 2]
                                   for k in ("wiu", "wo"))
        shares += tmoe.moe_ffn(held, x, share)[0]
    shares += mlp(p["shared"], x, cfg.act)
    m = dict(CELLS.small_kda_cell().config, num_experts=64,
             num_experts_per_token=8)
    m["expert_parallel"] = dict(m["expert_parallel"], router_experts=64,
                                first_held_expert=0)
    w = {"l1.router": p["router"], "l1.bias": p["bias"],
         "l1.experts_wiu": p["wiu"], "l1.experts_wo": p["wo"],
         "l1.shared_wiu": p["shared"]["wiu"],
         "l1.shared_wo": p["shared"]["wo"]}
    want = REF._moe(m, w, 1, x[0], "f32", None)
    torch.testing.assert_close(shares[0], want, rtol=1e-5, atol=1e-5)


def test_segments_and_layer_configs_reproduce_kimis_layer_kinds():
    """The 27 layers as the assembly builds them: each block's mixer (its
    layer's ``attn_kind``, its parameters' ``kda`` or ``attn``) and its
    feed-forward (``mlp`` or ``moe``) are those of ``config.json``'s
    ``linear_attn_config`` and ``first_k_dense_replace``."""
    m = Cell("kimi-linear-48b-a3b.serve-16k").config
    la = m["linear_attn_config"]
    want = [("kda" if i + 1 in la["kda_layers"] else "mla",
             "mlp" if i < m["first_k_dense_replace"] else "moe")
            for i in range(m["num_hidden_layers"])]
    assert sorted(la["kda_layers"] + la["full_attn_layers"]) == list(
        range(1, 28))
    cfg = get_config("kimi-linear-48b-a3b")
    shapes = ttf.param_shapes(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, held=(0, 8))))
    got = []
    for seg, seg_p, seg_ids in zip(ttf.segments(cfg), shapes["segments"],
                                   ttf.layer_ids(cfg)):
        for period, ids in zip(seg_p, seg_ids):
            for j, (kind, i) in enumerate(zip(seg.pattern, ids)):
                block = period[f"b{j}"]
                mixer = cfg.layer(i).attn_kind
                assert (mixer == "kda") == ("kda" in block) != (
                    "attn" in block)
                got.append((mixer, "moe" if kind == "moe" else "mlp"))
                assert ("moe" in block) == (kind == "moe")
    assert got == want
    assert GEN.program_config(m).kda == cfg.kda


def test_the_state_kind_at_the_published_widths():
    """The pool's one kind of page at the cell's widths: the latent rows
    of layer 3, the first MLA layer (576 wide, 18,432 B a 16-token page);
    the state slot of layer 0, the first KDA layer: 32 x 128 x 128 f32 and
    3 x 12,288 bf16, 2,170,880 B, the shapes of ``init_cache``'s entry."""
    cfg = get_config("kimi-linear-48b-a3b")
    (latent,) = pool_kinds(cfg, 16)
    assert (latent.name, latent.layer, latent.width) == ("latent", 3, 576)
    assert 16 * latent.width * 2 == 18_432
    assert tkda.state_bytes(cfg) == 32 * 128 * 128 * 4 + 3 * 12_288 * 2 \
        == 2_170_880 == REF.slot_bytes(Cell(
            "kimi-linear-48b-a3b.serve-16k").config)
    caches = ttf.init_cache(cfg, 1, 16, device="cpu")
    entry = ttf.layer_entry(caches, cfg, 0)
    assert {n: (tuple(x.shape), x.dtype) for n, x in entry.items()} == {
        n: ((1,) + shape, dt)
        for n, (shape, dt) in tkda.state_shapes(cfg).items()}
    assert ttf.layer_entry(caches, cfg, 3)["ckv"].shape == (1, 16, 512)


@pytest.mark.parametrize("requests,prefill,decode", [(3, 20, 4),
                                                     (2, 9, 7)])
def test_the_state_kinds_counters_are_exact(requests, prefill, decode):
    """serve.run of the smoke config: the state kind's slots, bytes held,
    reads and writes are the reference's accounting; the summed counters
    are the latent kind's; each sequence's slot, its layer-0 dense cache,
    holds the state its decode steps left."""
    cfg = get_smoke("kimi-linear-48b-a3b")
    r = tserve.run(cfg, requests=requests, prefill=prefill, decode=decode,
                   page_size=4, hbm_pages=5, device="cpu")
    kinds = r["kv_kinds"]
    slot = tkda.state_bytes(cfg)
    a = cfg.kda
    assert slot == (a.n_heads * a.head_dim ** 2 * 4
                    + (a.conv - 1) * 3 * a.n_heads * a.head_dim * 2)
    m = {"linear_attn_config": {"num_heads": a.n_heads,
                                "head_dim": a.head_dim,
                                "short_conv_kernel_size": a.conv},
         "dtype": cfg.dtype}
    assert kinds["state"] == REF.state_accounting(m, requests, decode)
    latent = dict(kinds["latent"])
    assert latent.pop("pages") == requests * math.ceil(
        (prefill + decode) / 4)
    assert latent == r["kv_stats"]
    for sid in range(requests):
        state = ttf.layer_entry(r["caches"][sid], cfg, 0)["S"]
        assert torch.isfinite(state).all() and torch.count_nonzero(state)
    assert r["logits_finite"]


def test_mla_without_a_query_lora_or_rotary_and_its_prefill_dispatch(
        monkeypatch):
    """Kimi-Linear's MLA layer: the query projected directly (``wq``, no
    LoRA leaves) and no rotary, its prefill through ``prefill_attention``
    (K5 on the card) at the plain scale; DeepSeek-V3's under YaRN keeps
    the loop at YaRN's scale, and its query LoRA."""
    from repro_torch.configs.base import YarnConfig
    from repro_torch.models import attention as tattn
    calls = []
    real = tattn.prefill_attention
    monkeypatch.setattr(tattn, "prefill_attention", lambda *a, **kw: (
        calls.append(1) or real(*a, **kw)))
    kimi = get_smoke("kimi-linear-48b-a3b").layer(2)
    deepseek = dataclasses.replace(get_smoke("deepseek-v3-671b"),
                                   rope_scaling=YarnConfig())
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((1, 12, 64), generator=gen).to(torch.bfloat16)
    pos = torch.arange(12)[None]
    for cfg, want in ((kimi, [1]), (deepseek, [])):
        p = tattn.mla_init(gen, cfg)
        assert ("wq" in p) == (cfg is kimi) != ("wq_a" in p)
        calls.clear()
        y, cache = tattn.mla_prefill(p, x, cfg, pos)
        assert calls == want and torch.isfinite(y.float()).all()
    # no rotary: the rope key is the projection's, the same at any position
    p = tattn.mla_init(gen, kimi)
    _, q_rope, _, k_rope = tattn._mla_qkv(p, x, kimi, pos)
    _, q_shift, _, k_shift = tattn._mla_qkv(p, x, kimi, pos + 5)
    assert torch.equal(q_rope, q_shift) and torch.equal(k_rope, k_shift)
