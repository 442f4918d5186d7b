"""DeepSeek-V3's serving path as one expert-parallel rank holds it, on the
CPU at smoke size, against the benchmark's plain reference
(``bench/reference/mla_moe_lm.py``, loaded by path) and hand-written
transcriptions of the published code:

* the gate (sigmoid scores, a score-correction bias, group-limited top-k)
  against a transcription of DeepSeek-V3's ``Gate``, on seeded scores, on
  ties and where the bias moves a group in;
* a layer that holds a share of the experts: the shares' outputs, with the
  shared expert counted once, sum to the whole layer's, which matches the
  reference's;
* YaRN at the published rope dims: the ramp's ends and the softmax factor;
* ``serve.run`` against the reference (prefill, then decode through the
  cache, against the full forward's logits) through the benchmark's
  generator, and the latent pool's pricing and counters against the
  reference's accounting;
* K4's plain version over a latent pool against an explicit absorbed
  attention.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import YarnConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.launch import serve as tserve
from repro_torch.memory.kvcache import PagedKVCache
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import rope as trope

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:       # the benchmark's harness, as it runs
    sys.path.append(str(BENCH))

from harness.core import Cell, load_module  # noqa: E402

REF = load_module(BENCH / "reference" / "mla_moe_lm.py", "test_mla_ref_")
HYBRID_REF = load_module(BENCH / "reference" / "hybrid_moe_lm.py",
                         "test_mla_hybrid_ref_")
GEN = load_module(BENCH / "generators" / "serve_mla_moe.py", "test_mla_gen_")
CELLS = load_module(BENCH / "tests" / "bench_mla_cells.py", "test_mla_cells_")
CPU = torch.device("cpu")


def deepseek_gate(x, weight, bias, n_groups, topk_groups, topk, route_scale):
    """DeepSeek-V3's ``Gate.forward`` (``inference/model.py``), sigmoid
    scoring with a bias, transcribed: `weight` (E, D) as its linear's."""
    scores = torch.nn.functional.linear(x, weight)
    scores = scores.sigmoid()
    original_scores = scores
    scores = scores + bias
    scores = scores.view(x.size(0), n_groups, -1)
    group_scores = scores.topk(2, dim=-1)[0].sum(dim=-1)
    indices = group_scores.topk(topk_groups, dim=-1)[1]
    mask = scores.new_ones(x.size(0), n_groups, dtype=bool).scatter_(
        1, indices, False)
    scores = scores.masked_fill_(mask.unsqueeze(-1), float("-inf")).flatten(1)
    indices = torch.topk(scores, topk, dim=-1)[1]
    weights = original_scores.gather(1, indices)
    weights /= weights.sum(dim=-1, keepdim=True)
    weights *= route_scale
    return weights, indices


def gate_config(e=32, groups=8, keep=4, k=8, held=None):
    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=e, top_k=k, scoring="sigmoid", n_group=groups,
        topk_group=keep, routed_scale=2.5, score_bias=True, held=held))


def _logit_case(case):
    """(logits (T, E), bias (E,)) of a gate case over 32 experts in 8
    groups of 4."""
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((64, 32), generator=gen)
    bias = 0.1 * torch.randn((32,), generator=gen)
    if case == "ties":
        # a quarter of the logits share four values, groups tie too
        logits[:, ::4] = torch.tensor([0.5, -0.25, 1.0, 0.0, 0.5, 1.0, 0.0,
                                       -0.25])
        bias = torch.zeros(32)
    if case == "bias_moves_a_group":
        logits = torch.zeros((4, 32)) - 2.0
        logits[:, :16] = 1.0                    # groups 0-3 score best
        bias = torch.zeros(32)
        bias[28:30] = 2.0                       # group 7 only by its bias
    return logits, bias


@pytest.mark.parametrize("case", ["seeded", "ties", "bias_moves_a_group"])
def test_gate_matches_deepseeks_gate(case):
    logits, bias = _logit_case(case)
    cfg = gate_config()
    # x @ eye: the router's logits are the case's
    params = {"router": torch.eye(32), "bias": bias}
    w, e = tmoe.gate(params, logits, cfg)
    want_w, want_e = deepseek_gate(logits, torch.eye(32), bias, 8, 4, 8, 2.5)
    assert torch.equal(e, want_e)
    torch.testing.assert_close(w, want_w, rtol=1e-6, atol=1e-7)
    ref_w, ref_e = REF.gate({"n_group": 8, "topk_group": 4,
                             "num_experts_per_tok": 8,
                             "routed_scaling_factor": 2.5},
                            torch.sigmoid(logits), bias)
    assert torch.equal(torch.sort(ref_e).values, torch.sort(e).values)
    if case == "bias_moves_a_group":
        # group 7 is kept for its bias; its experts weigh their unbiased
        # scores, sigmoid(-2), against the others' sigmoid(1)
        assert ((e >= 28) & (e < 30)).sum(-1).tolist() == [2] * 4
        share = torch.sigmoid(torch.tensor(-2.0)) / (
            2 * torch.sigmoid(torch.tensor(-2.0))
            + 6 * torch.sigmoid(torch.tensor(1.0)))
        torch.testing.assert_close(w[e == 28], 2.5 * share.expand(4))


def _moe_params(cfg, gen):
    m = cfg.moe
    d, f = cfg.d_model, m.expert_d_ff
    return {"router": torch.randn((d, m.n_experts), generator=gen) * d ** -.5,
            "bias": 0.2 * torch.randn((m.n_experts,), generator=gen),
            "wiu": torch.randn((m.n_held, d, 2 * f), generator=gen) * d ** -.5,
            "wo": torch.randn((m.n_held, f, d), generator=gen) * f ** -.5,
            "shared": {"wiu": torch.randn((d, 2 * f), generator=gen)
                       * d ** -.5,
                       "wo": torch.randn((f, d), generator=gen) * f ** -.5}}


#: the gates of the held-share test: DeepSeek-V3's (groups, a shared
#: expert, a routed scale) and MiMo-V2-Flash's (one group, no shared
#: expert, scale 1)
SHARE_GATES = {
    "deepseek": dict(n_group=4, topk_group=2, routed_scale=2.5, shared=True),
    "mimo": dict(n_group=1, topk_group=1, routed_scale=1.0, shared=False),
}


@pytest.mark.parametrize("gate", list(SHARE_GATES))
def test_held_shares_sum_to_the_uncut_layer(gate):
    """8 experts (DeepSeek's gate: 4 groups of 2, the best 2 kept; MiMo's:
    one group), top 3, as 4 shares of 2: each share routes over all 8 and
    computes its own experts' part; the parts, with the shared expert
    (which every share computes) counted once, sum to the layer that holds
    all 8, which matches the model's reference's uncut layer."""
    g = SHARE_GATES[gate]
    base = dataclasses.replace(get_smoke("deepseek-v3-671b"),
                               dtype="float32")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=8, top_k=3, scoring="sigmoid",
        n_group=g["n_group"], topk_group=g["topk_group"],
        routed_scale=g["routed_scale"], score_bias=True, held=(0, 8),
        n_shared=int(g["shared"])))
    params = _moe_params(cfg, torch.Generator().manual_seed(5))
    if not g["shared"]:
        del params["shared"]
    x = torch.randn((2, 7, cfg.d_model), generator=torch.Generator()
                    .manual_seed(6))
    whole, aux = tmoe.moe_ffn(params, x, cfg)
    assert float(aux) == 0.0
    shared = (tmoe.mlp(params["shared"], x, cfg.act) if g["shared"]
              else torch.zeros_like(x))
    parts = []
    for first in range(0, 8, 2):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, held=(first, 2)))
        p = dict(params, wiu=params["wiu"][first:first + 2],
                 wo=params["wo"][first:first + 2])
        y, _ = tmoe.moe_ffn(p, x, share)
        parts.append(y - shared)
    torch.testing.assert_close(sum(parts) + shared, whole, rtol=1e-5,
                               atol=1e-6)
    m = {"n_group": g["n_group"], "topk_group": g["topk_group"],
         "num_experts_per_tok": 3, "n_routed_experts": 8,
         "routed_scaling_factor": (g["routed_scale"] if g["shared"]
                                   else None),
         "norm_topk_prob": True, "expert_parallel": {"first_held_expert": 0}}
    w = {"l0.router": params["router"], "l0.bias": params["bias"],
         "l0.experts_wiu": params["wiu"], "l0.experts_wo": params["wo"]}
    if g["shared"]:
        w.update({"l0.shared_wiu": params["shared"]["wiu"],
                  "l0.shared_wo": params["shared"]["wo"]})
    ref = REF if g["shared"] else HYBRID_REF
    want = ref._moe(m, w, 0, x.reshape(-1, cfg.d_model), "f32", None)
    torch.testing.assert_close(whole.reshape(-1, cfg.d_model), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("held,tokens", [((0, 8), 1), ((2, 4), 1),
                                         ((2, 4), 3), ((6, 2), 5)])
def test_decode_runs_every_held_expert_as_the_sorted_dispatch(held, tokens):
    """A decode step's held layer (every held expert on every token,
    weighted by the gate, zero where not routed) against the sorted
    dispatch on the same tokens, in float32, for shares of 8 experts
    (4 groups of 2, the best 2 kept, top 3)."""
    base = dataclasses.replace(get_smoke("deepseek-v3-671b"),
                               dtype="float32")
    whole = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=8, top_k=3, scoring="sigmoid", n_group=4,
        topk_group=2, routed_scale=2.5, score_bias=True, held=(0, 8)))
    params = _moe_params(whole, torch.Generator().manual_seed(tokens))
    first, n = held
    cfg = dataclasses.replace(whole, moe=dataclasses.replace(
        whole.moe, held=held))
    p = dict(params, wiu=params["wiu"][first:first + n],
             wo=params["wo"][first:first + n])
    x = torch.randn((tokens, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(7 + tokens))
    want, _ = tmoe.moe_ffn(p, x, cfg)
    got, aux = tmoe.moe_ffn(p, x, cfg, decode=True)
    assert float(aux) == 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_held_layer_counts_its_routes():
    """The benchmark's count of each batch's held assignments in its decode
    steps (for the decode FLOPs), read from the routes the program's gate
    chose, is in float32 the count of the reference's own routing of every
    request's decoded tokens."""
    run = GEN.Run(_f32_cell(), 2**31 + 9, CPU)
    run.window(0.0)
    run.release()
    tr, (first, n) = run.tr, run.cfg.moe.held
    prompts, _ = run._inputs()
    want = 0
    for r in range(tr["requests"]):
        _, toks = run.served(0, r)
        seq = torch.cat([torch.as_tensor(prompts[r]), toks[:-1]])
        routes = []
        REF.forward(run.m, run.weights, seq, [seq.shape[0] - 1],
                    routes=routes)
        want += sum(int(((e >= first) & (e < first + n)).sum())
                    for e in (e[tr["prefill"]:] for e in routes))
    total = tr["requests"] * tr["decode"] * 2 * 4
    assert 0 < want < total
    assert run.counters()["decode_held"] == [want]


def test_yarn_at_the_published_dims():
    """DeepSeek-V3's rope (64 dims, theta 10,000, YaRN factor 40 over
    4,096 positions, beta 32 / 1): pairs 10 and 23 end the ramp, below
    them theta's frequencies, above them a fortieth; the MLA softmax scale
    gains mscale(40, 1) ** 2 = 1.87386 (192 ** -0.5 x 1.87386 = 0.13523);
    the reference gives the same frequencies."""
    y = YarnConfig()
    assert trope.yarn_ramp(64, 10_000.0, y) == (10, 23)
    ratio = trope.rope_freqs(64, 10_000.0, scaling=y) / trope.rope_freqs(
        64, 10_000.0)
    torch.testing.assert_close(ratio[:11], torch.ones(11))
    torch.testing.assert_close(ratio[23:], torch.full((9,), 1 / 40))
    torch.testing.assert_close(ratio[16], torch.tensor(
        1 - 6 / 13 * (1 - 1 / 40)))
    assert trope.yarn_softmax_factor(y) == pytest.approx(1.87386, abs=1e-5)
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              rope_scaling=y)
    assert tattn.mla_softmax_scale(cfg) == pytest.approx(0.13523, abs=1e-5)
    assert tattn.mla_softmax_scale(get_config("deepseek-v3-671b")) == \
        192 ** -0.5
    m = Cell("deepseek-v3-671b.serve-spill").config
    torch.testing.assert_close(REF.yarn_inv_freq(m, "cpu"),
                               trope.rope_freqs(64, 10_000.0, scaling=y))
    assert REF.softmax_scale(m) == pytest.approx(
        tattn.mla_softmax_scale(cfg), rel=1e-12)


def _f32_cell():
    cell = CELLS.small_mla_moe_cell()
    cell.config["dtype"] = "float32"
    return cell


def test_served_tokens_logits_and_routes_match_the_reference():
    """The benchmark's run in float32: every served token the reference's
    greedy choice, the logits of prefill and decode through the latent
    cache within 1e-5 of the full forward's, the same held routes, K4's
    outputs the reference's latent attention."""
    run = GEN.Run(_f32_cell(), 2**31 + 5, CPU)
    run.window(0.0)
    run.release()
    r = run.readings()
    assert r["token_gap"] == 0.0 and r["route_mismatch"] == 0
    assert r["logit_err"] < 1e-5 and r["attn_err"] < 1e-5
    # the loop prices a page at 2 B an element whatever the dtype, the
    # reference at the dtype's size: float32 pages differ
    assert r["kv_mismatch"] > 0
    # each of the 2 MoE layers routes every prompt and decoded token
    assert [e.shape for e in run.routes] == [(24, 4)] * 3 * 2 + [(1, 4)] * (
        3 * 6 * 2)


def test_served_through_step_graphs_as_eagerly():
    """The benchmark's float32 run with each sequence's steps through a
    :class:`StepGraph` whose stand-in graph (a CUDA graph needs the card)
    runs the step eagerly at every replay: the readings and the recorded
    routes those of the eager run."""
    import types

    from repro_torch.models import transformer as ttf

    graphable, capture = ttf.graphable, ttf.StepGraph.capture
    replays = []

    def stand_in(self):
        def replay():
            replays.append(1)
            self.logits = self._run()
        self.graph = types.SimpleNamespace(replay=replay)

    ttf.graphable = lambda cfg, device: graphable(cfg, "cuda")
    ttf.StepGraph.capture = stand_in
    try:
        run = GEN.Run(_f32_cell(), 2**31 + 5, CPU)
        warm = len(replays)
        run.window(0.0)
        run.release()
    finally:
        ttf.graphable, ttf.StepGraph.capture = graphable, capture
    # 3 sequences, each step but the first replayed
    assert (warm, len(replays) - warm) == (3 * 1, 3 * 5)
    r = run.readings()
    assert r["token_gap"] == 0.0 and r["route_mismatch"] == 0
    assert r["logit_err"] < 1e-5 and r["attn_err"] < 1e-5
    assert [e.shape for e in run.routes] == [(24, 4)] * 3 * 2 + [(1, 4)] * (
        3 * 6 * 2)


@pytest.mark.cuda
def test_replayed_steps_record_the_eager_steps_routes_on_the_card():
    """On the card, the benchmark's run of the held cell at smoke widths
    with each sequence's steps replayed from CUDA graphs (cut at the held
    layers' spans) against the same run with every step eager: the same
    tokens, the same routes recorded in the same order (a replayed step's
    copied from what its capture recorded), and the same readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import transformer as ttf

    card = torch.device("cuda", 0)
    graphed = GEN.Run(_f32_cell(), 2**31 + 11, card)
    graphed.window(0.0)
    graphed.release()
    graphable = ttf.graphable
    ttf.graphable = lambda cfg, device: False
    try:
        eager = GEN.Run(_f32_cell(), 2**31 + 11, card)
        eager.window(0.0)
        eager.release()
    finally:
        ttf.graphable = graphable
    assert graphed.calls[0]["tokens"] == eager.calls[0]["tokens"]
    assert len(graphed.routes) == len(eager.routes) == 3 * 2 * (1 + 6)
    assert all(torch.equal(a, b) for a, b in zip(graphed.routes,
                                                 eager.routes))
    assert graphed.readings() == eager.readings()


def test_a_cut_step_hands_its_spans_to_the_cutter():
    """A decode step of the held cell at smoke widths under
    ``cut_at_spans`` (as a capture in pieces runs it): each MoE layer's
    ``moe.route`` then ``moe.experts`` open the cutter's context, not a
    profiler range, and the logits are bitwise those of the step without
    it; after it, a span is the profiler's again."""
    import contextlib

    from repro_torch.models import transformer as ttf
    from repro_torch.runtime import trace as ttrace

    cell = _f32_cell()
    m = cell.config
    cfg = GEN.program_config(m)
    params = GEN.program_params(m, REF.make_params(
        m, 2**31 + 3, CPU, cell.traffic["norm_noise"]))
    toks = torch.arange(9, dtype=torch.int32)[None] * 7 % cfg.vocab_size
    _, cache = ttf.forward_prefill(params, cfg, toks[:, :8])
    cache = ttf.pad_cache(cache, cfg, 12)
    twin = [[{b: {k: v.clone() for k, v in e.items()} for b, e in p.items()}
             for p in seg] for seg in cache]
    seen = []

    @contextlib.contextmanager
    def cutter(name, id):
        seen.append((name, id))
        yield

    want, _ = ttf._decode(params, cfg, toks[:, 8], cache, 8)
    with torch.autograd.profiler.profile() as prof, \
            ttrace.cut_at_spans(cutter):
        got, _ = ttf._decode(params, cfg, toks[:, 8], twin, torch.tensor(8))
    n_moe = m["num_hidden_layers"] - m["first_k_dense_replace"]
    assert seen == [("moe.route", None), ("moe.experts", None)] * n_moe
    assert not [e for e in prof.function_events
                if e.name.startswith(ttrace.PREFIX)]
    assert torch.equal(got, want)
    assert ttrace.span("moe.route") is ttrace._OFF


@pytest.mark.parametrize("shape", [(3, 24, 6, 4, 5), (2, 7, 9, 2, 1),
                                   (5, 37, 20, 4, 3)])
def test_latent_pool_prices_its_row_as_the_reference(shape):
    requests, prefill, decode, page, hbm = shape
    cfg = get_smoke("deepseek-v3-671b")
    kv = PagedKVCache(cfg, n_pages=4, page_size=page, max_blocks=2,
                      hbm_page_budget=2, device="cpu")
    m = dict(CELLS.small_mla_moe_cell().config, dtype="bfloat16")
    assert kv.row() == (1, 24) and kv.k_pool[0].shape == (4, page, 1, 24)
    assert kv.page_bytes() == REF.latent_page_bytes(m, page) == page * 48
    out = tserve.run(cfg, requests=requests, prefill=prefill, decode=decode,
                     page_size=page, hbm_pages=hbm, device="cpu")
    rd, wr = REF.cxl_payload_gbps(CELLS.small_mla_moe_cell().traffic["cxl"])
    assert out["kv_stats"] == REF.kv_accounting(
        requests, prefill, decode, page, hbm, page * 48, rd, wr)


@pytest.mark.parametrize("b,h,page,nblk", [(3, 16, 4, 5), (2, 4, 16, 3)])
def test_plain_k4_is_the_absorbed_attention_over_the_latent(b, h, page,
                                                            nblk):
    """Keys the whole latent row (kv_lora + rope), values its first
    kv_lora columns, at a given scale; an empty context gives 0; GQA calls
    (no v_dim) keep their output."""
    rng = np.random.default_rng(b * h)
    w, dv, n_pages = 24, 16, b * nblk
    q = torch.from_numpy(rng.standard_normal((b, h, w)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal(
        (n_pages, page, 1, w)).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(n_pages).reshape(b, nblk)
                          .astype(np.int32))
    cl = torch.from_numpy(rng.integers(1, nblk * page + 1, (b,))
                          .astype(np.int32))
    cl[0] = 0
    scale = 0.3
    tops.reset_launches()
    got = tops.paged_attention(q, pool, pool, bt, cl, scale=scale, v_dim=dv)
    assert tops.LAUNCHES["paged_attention_ref"] == 1
    assert got.shape == (b, h, dv) and torch.all(got[0] == 0)
    for s in range(1, b):
        rows = torch.cat([pool[pg, :, 0] for pg in bt[s]])[:int(cl[s])]
        att = torch.softmax(q[s].double() @ rows.double().T * scale, -1)
        torch.testing.assert_close(got[s].double(), att @ rows[:, :dv]
                                   .double(), rtol=1e-5, atol=1e-6)
    gqa = tops.paged_attention(q, pool, pool, bt, cl)
    torch.testing.assert_close(gqa, tpa.paged_attention_ref(
        q, pool, pool, bt, cl, scale=w ** -0.5, v_dim=w))
    assert tpa.bound_bytes(q, pool, bt, cl, v_dim=dv, shared_kv=True) == (
        b * h * (w + dv) * 4 + int(cl.sum()) * w * 4
        + 4 * (int(((cl + page - 1) // page).sum()) + b))
    with pytest.raises(ValueError, match="v_dim"):
        tops.paged_attention(q, pool, pool, bt, cl, v_dim=w + 1)
