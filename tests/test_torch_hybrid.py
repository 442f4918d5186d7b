"""MiMo-V2-Flash's serving path (window and full GQA layers with their own
KV heads, rope thetas and sinks, q and k 192 / v 128, a pool of two kinds),
on the CPU at smoke size, against the benchmark's plain reference
(``bench/reference/hybrid_moe_lm.py``, loaded by path) and explicit
softmaxes:

* ``serve.run`` through the benchmark's generator, in float32: prefill,
  then decode through both kinds of cache (a window of 8 shorter than the
  24-token prompt, so that the rings roll), against the full forward's
  logits, the reference's routes, both pool kinds' attention and the
  reference's two-kind accounting; eagerly and through step graphs;
* ``blockwise_attention``, K4's plain version and the decode einsums with
  sinks and values narrower than the keys, against a softmax with a sink
  column;
* partial rotary at the full and the window layers' thetas;
* the pool's kinds: rows, rings and page prices at the published widths,
  and its counters against the reference's at several shapes;
* the registry: ``ARCHS`` mirrors the JAX package's, the port's own
  architecture beside it, its parameter count the configuration file's.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.launch import serve as tserve
from repro_torch.memory.kvcache import PagedKVCache, pool_kinds
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:       # the benchmark's harness, as it runs
    sys.path.append(str(BENCH))

from harness.core import Cell, load_module  # noqa: E402

REF = load_module(BENCH / "reference" / "hybrid_moe_lm.py",
                  "test_hybrid_ref_")
GEN = load_module(BENCH / "generators" / "serve_hybrid_moe.py",
                  "test_hybrid_gen_")
CELLS = load_module(BENCH / "tests" / "bench_hybrid_cells.py",
                    "test_hybrid_cells_")
CPU = torch.device("cpu")


def _f32_cell():
    cell = CELLS.small_hybrid_cell()
    cell.config["dtype"] = "float32"
    return cell


@pytest.mark.parametrize("graphs", [False, True])
def test_served_logits_attention_routes_and_pool_match_the_reference(
        graphs):
    """The benchmark's run in float32 (6 layers: full, 4 window, full; a
    window of 8 under a 24-token prompt): every served token the
    reference's greedy choice, the logits of prefill and decode through
    both kinds of cache within 1e-5 of the full forward's, the same held
    routes, both pool kinds' K4 outputs the reference's attention, every
    counter, summed and per kind, the reference's.  With `graphs`, each
    sequence's steps go through a StepGraph whose stand-in graph (a CUDA
    graph needs the card) runs the step eagerly at every replay."""
    import types

    graphable, capture = ttf.graphable, ttf.StepGraph.capture
    replays = []

    def stand_in(self):
        def replay():
            replays.append(1)
            self.logits = self._run()
        self.graph = types.SimpleNamespace(replay=replay)

    if graphs:
        ttf.graphable = lambda cfg, device: graphable(cfg, "cuda")
        ttf.StepGraph.capture = stand_in
    try:
        run = GEN.Run(_f32_cell(), 2**31 + 5, CPU)
        warm = len(replays)
        run.window(0.0)
        run.release()
    finally:
        ttf.graphable, ttf.StepGraph.capture = graphable, capture
    assert len(replays) - warm == (3 * 5 if graphs else 0)
    m, tr = run.m, run.tr
    assert m["sliding_window"] < tr["prefill"]
    r = run.readings()
    assert r["token_gap"] == 0.0 and r["route_mismatch"] == 0
    assert r["logit_err"] < 1e-5 and r["attn_err"] < 1e-5
    assert r["kv_mismatch"] == 0
    kinds = run.calls[0]["kv_kinds"]
    assert kinds["window"]["pages"] == 3 * 2        # 8-token rings of 4
    assert kinds["full"]["pages"] == 3 * -(-(24 + 6) // 4)
    assert [len(x) for x in run.calls[0]["kind_attn_out"]] == [6, 6]
    # each of the 5 MoE layers routes every prompt and decoded token
    assert [e.shape for e in run.routes] == [(24, 4)] * 3 * 5 + [(1, 4)] * (
        3 * 6 * 5)


def _explicit(q, k, v, sinks, allowed):
    """softmax(q k^T / sqrt(hd), sink) v in float64: q (N, hd); k (S, N,
    hd); v (S, N, hv); allowed (S,) or (N, S)."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.einsum("nd,snd->ns", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~allowed, -torch.inf)
    col = (sinks.double() if sinks is not None
           else torch.full((q.shape[0],), -torch.inf, dtype=torch.float64))
    p = torch.cat([s, col[:, None]], dim=-1).softmax(-1)[:, :-1]
    return torch.einsum("ns,snd->nd", p, v)


@pytest.mark.parametrize("window,chunk,sinks", [
    (None, 5, True), (6, 4, True), (6, 16, False), (None, 16, False)])
def test_blockwise_attention_with_sinks_and_narrow_values(window, chunk,
                                                          sinks):
    """The prefill's loop with values narrower than the keys (16 of 24),
    GQA (6 query heads over 2), a window or none, ragged chunks, and a sink
    logit per head (which takes mass and adds no value) or none, against
    an explicit softmax with a sink column, in float32."""
    gen = torch.Generator().manual_seed(11)
    s, n, kh, hd, hv = 13, 6, 2, 24, 16
    q = torch.randn((1, s, n, hd), generator=gen)
    k = torch.randn((1, s, kh, hd), generator=gen)
    v = torch.randn((1, s, kh, hv), generator=gen)
    sk = 2 * torch.randn((n,), generator=gen) if sinks else None
    got = tattn.blockwise_attention(q, k, v, window=window, kv_chunk=chunk,
                                    sinks=sk)
    assert got.shape == (1, s, n, hv)
    rep = n // kh
    kk, vv = (x[0].repeat_interleave(rep, dim=1) for x in (k, v))
    pos = torch.arange(s)
    for t in range(s):
        allowed = pos <= t
        if window is not None:
            allowed &= pos > t - window
        want = _explicit(q[0, t], kk, vv, sk, allowed[None].expand(n, s))
        torch.testing.assert_close(got[0, t].double(), want, rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("sinks", [True, False])
def test_plain_k4_and_decode_einsums_with_sinks_and_narrow_values(sinks):
    """K4's plain version over a pool whose V rows (16) are narrower than
    its K rows (24), in their own pool, with a sink per query head or
    none, and the decode einsums over the same rows as dense caches,
    against an explicit softmax with a sink column; an empty context gives
    0; the plain calls with sinks are counted."""
    rng = np.random.default_rng(3)
    b, h, kh, d, dv, page, nblk = 3, 8, 2, 24, 16, 4, 3
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (b * nblk, page, kh, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (b * nblk, page, kh, dv)).astype(np.float32))
    bt = torch.arange(b * nblk, dtype=torch.int32).reshape(b, nblk)
    cl = torch.tensor([0, 7, 12], dtype=torch.int32)
    sk = torch.from_numpy(rng.standard_normal(h).astype(np.float32) + 1.5) \
        if sinks else None
    tops.reset_launches()
    got = tops.paged_attention(q, kp, vp, bt, cl, sinks=sk)
    assert tops.LAUNCHES["paged_attention_ref"] == 1
    assert tops.LAUNCHES["attention_sinks_ref"] == int(sinks)
    assert got.shape == (b, h, dv) and torch.all(got[0] == 0)
    k_cache = kp.reshape(b, nblk * page, kh, d)
    v_cache = vp.reshape(b, nblk * page, kh, dv)
    dense = tattn.decode_attention_ref(q, k_cache, v_cache, cl, sk)
    for s in range(1, b):
        n = int(cl[s])
        want = _explicit(q[s], k_cache[s, :n].repeat_interleave(4, dim=1),
                         v_cache[s, :n].repeat_interleave(4, dim=1), sk,
                         torch.ones((h, n), dtype=torch.bool))
        torch.testing.assert_close(got[s].double(), want, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(dense[s].double(), want, rtol=1e-5,
                                   atol=1e-6)
    assert tpa.bound_bytes(q, kp, bt, cl, v_dim=dv, sinks=sinks) == (
        b * h * (d + dv) * 4 + int(cl.sum()) * kh * (d + dv) * 4
        + 4 * (int(((cl + page - 1) // page).sum()) + b) + 4 * h * sinks)
    with pytest.raises(ValueError, match="sinks"):
        tops.paged_attention(q, kp, vp, bt, cl, sinks=torch.zeros(h - 1))


@pytest.mark.parametrize("layer", [0, 1])
def test_partial_rotary_at_the_layer_s_theta(layer):
    """At the published widths, the full layer (0) rotates the leading 64
    of its 192 q and k dims at theta 5,000,000 and the window layer (1) at
    10,000, as halves of those dims, the reference's rotation; the other
    128 dims pass unchanged, and the two thetas give other rotations."""
    cfg = get_config("mimo-v2-flash-309b")
    lc = cfg.layer(layer)
    assert lc.rot_dim == 64 == REF.rotary_dims(Cell(
        "mimo-v2-flash-309b.serve-4k").config)
    assert lc.rope_theta == (5_000_000.0, 10_000.0)[layer]
    gen = torch.Generator().manual_seed(layer)
    x = torch.randn((1, 40, 3, 192), generator=gen)
    pos = (torch.arange(40, dtype=torch.int32) * 97)[None]
    got = tattn._apply_positional(x, pos, lc)
    want = REF._rope(x[0], pos[0], {"head_dim": 192,
                                   "partial_rotary_factor": 0.334},
                     lc.rope_theta)
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[..., 64:], x[..., 64:])
    other = tattn._apply_positional(x, pos, cfg.layer(1 - layer))
    assert float((other - got)[..., :64].abs().max()) > 0.1


def test_pool_kinds_at_the_published_widths():
    """The cut's pool: the full kind holds layer 0's rows, 4 KV heads of
    192 + 128, a 16-token page 40,960 B; the window kind layer 1's, 8 KV
    heads, 81,920 B, a ring of 128 / 16 = 8 pages; the reference prices
    them alike."""
    m = Cell("mimo-v2-flash-309b.serve-4k").config
    cfg = GEN.program_config(m)
    full, window = pool_kinds(cfg, 16)
    assert (full.layer, full.heads, full.width, full.v_width, full.ring) == (
        0, 4, 192, 128, None)
    assert (window.layer, window.heads, window.width, window.v_width,
            window.ring) == (1, 8, 192, 128, 8)
    kv = PagedKVCache(cfg, n_pages=[1, 1], page_size=16, max_blocks=1,
                      hbm_page_budget=1, device="cpu")
    assert (kv.page_bytes(0), kv.page_bytes(1)) == (40_960, 81_920)
    assert (REF.page_bytes(m, 16, False), REF.page_bytes(m, 16, True)) == (
        40_960, 81_920)
    assert REF.pool_layers(m) == (0, 1) and REF.ring_pages(m, 16) == 8
    assert len(pool_kinds(get_config("h2o-danube-3-4b"), 16)) == 1


@pytest.mark.parametrize("shape", [(3, 24, 6, 4, 5), (2, 7, 9, 2, 1),
                                   (4, 37, 20, 4, 11), (2, 30, 3, 4, 40)])
def test_pool_counters_match_the_reference_accounting(shape):
    """`serve.run` on the smoke config (window 8): the pool's counters,
    summed and per kind with each kind's live pages, equal the reference's
    two-kind accounting at the smoke widths' page prices, for prompts
    shorter and longer than the window and budgets from 1 page to all."""
    requests, prefill, decode, page, hbm = shape
    cfg = get_smoke("mimo-v2-flash-309b")
    out = tserve.run(cfg, requests=requests, prefill=prefill, decode=decode,
                     page_size=page, hbm_pages=hbm, device="cpu")
    kinds = pool_kinds(cfg, page)
    prices = [page * k.heads * (k.width + k.v_width) * 2 for k in kinds]
    m = Cell("mimo-v2-flash-309b.serve-4k")
    rd, wr = REF.cxl_payload_gbps(m.traffic["cxl"])
    want = REF.kv_accounting(
        requests, prefill, decode, page, hbm,
        [{"page_bytes": p, "ring": k.ring} for p, k in zip(prices, kinds)],
        rd, wr)
    assert out["kv_stats"] == pytest.approx(want["total"], rel=1e-12)
    for k, w in zip(kinds, want["kinds"]):
        assert out["kv_kinds"][k.name] == pytest.approx(w, rel=1e-12)
    assert out["kv_kinds"]["window"]["pages"] == requests * min(
        -(-(prefill + decode) // page), 8 // page)


def test_archs_mirror_the_jax_registry():
    """``ARCHS`` is the JAX package's registry, in its order, so the JAX
    parity tests' parameter sets are unchanged; the port's own
    architectures (MiMo-V2-Flash, Kimi-Linear) lie beside it, MiMo's
    resolved by ``get_config``, and its parameters at the cut (meta
    tensors) are the configuration file's count."""
    from repro.configs import ARCHS as JAX_ARCHS
    assert ARCHS == tuple(JAX_ARCHS)
    assert PORT_ARCHS == ARCHS + ("mimo-v2-flash-309b", "kimi-linear-48b-a3b")
    assert get_config("mimo-v2-flash-309b").arch == "mimo-v2-flash-309b"
    m = Cell("mimo-v2-flash-309b.serve-4k").config
    shapes = ttf.param_shapes(GEN.program_config(m))
    assert ttf.n_param_elements(shapes) == m["parameters"] == 4_794_195_264
    with open(BENCH.parent / "BENCHMARK.json") as f:
        entry = next(c for c in json.load(f)["configs"]
                     if c["name"] == "mimo-v2-flash-309b")
    assert entry["reduced"] == m["reduced"]


def test_window_layers_keep_a_ring_and_full_layers_the_context():
    """The smoke config's caches: a window layer's k and v a ring of the
    window's slots (8) over its 2 KV heads, v 16 wide; a full layer's the
    whole capacity over 1; the window layers' parameters carry a sink per
    query head and a wider wqkv."""
    cfg = get_smoke("mimo-v2-flash-309b")
    caches = ttf.init_cache(cfg, 2, 30, device="cpu")
    full, window = (ttf.layer_entry(caches, cfg, i) for i in (0, 1))
    assert full["k"].shape == (2, 30, 1, 24) and full["v"].shape == (
        2, 30, 1, 16)
    assert window["k"].shape == (2, 8, 2, 24) and window["v"].shape == (
        2, 8, 2, 16)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p0, p1 = (ttf.layer_entry(params["segments"], cfg, i)["attn"]
              for i in (0, 1))
    assert "sinks" not in p0 and p1["sinks"].shape == (4,)
    assert p0["wqkv"].shape == (64, 4 * 24 + 24 + 16)
    assert p1["wqkv"].shape == (64, 4 * 24 + 2 * 24 + 2 * 16)
    assert p0["wo"].shape == p1["wo"].shape == (4 * 16, 64)
