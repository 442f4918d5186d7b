"""The GQA decode step's attention on K4, checked on the CPU.

:func:`repro_torch.kernels.paged_attention.decode_attention` views a dense
cache (B, S, K, D) as a pool of pages read through an identity block table
(:func:`dense_pages`, :func:`dense_layout`); K4's plain version over that
view is held here against the model's einsums
(:func:`repro_torch.models.attention.decode_attention_ref`) within 3e-5 in
float32 (the two scale the logits at different points and sum in
different orders).  Then the dispatch of
:func:`repro_torch.models.attention.decode_attention`: every input K4 does
not take keeps the einsums bitwise, and the counters say which path ran.
The card's side is in ``tests/test_torch_card.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf


def qkv(b, s, h, kh, d, dtype="float32", seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, d), generator=g)
    k = torch.randn((b, s, kh, d), generator=g)
    v = torch.randn((b, s, kh, d), generator=g)
    return [x.to(getattr(torch, dtype)) for x in (q, k, v)]


@pytest.mark.parametrize("s,page", [(8200, 8), (1088, 16), (16, 16),
                                    (20, 4), (18, 2), (7, 1), (1, 1)])
@pytest.mark.parametrize("b", [1, 3])
def test_dense_layout_is_the_largest_page_and_the_identity(s, page, b):
    """The largest page of 16, 8, 4, 2, 1 dividing S, and sequence i's
    pages i * S / page onwards, in order: a function of the shape alone,
    built once."""
    got_page, table = tpa.dense_layout(b, s, torch.device("cpu"))
    assert got_page == page and table.dtype == torch.int32
    assert torch.equal(table.flatten(),
                       torch.arange(b * s // page, dtype=torch.int32))
    assert table.shape == (b, s // page)
    assert tpa.dense_layout(b, s, "cpu")[1] is table


def test_dense_layout_keeps_the_last_shapes_tables():
    """Tables are kept per shape for the last ``DENSE_LAYOUTS`` shapes; an
    older one is built again, equal."""
    first = tpa.dense_layout(1, 1000, "cpu")[1]
    for s in range(1001, 1001 + tpa.DENSE_LAYOUTS):
        last = tpa.dense_layout(1, s, "cpu")[1]
    assert tpa.dense_layout(1, s, "cpu")[1] is last
    again = tpa.dense_layout(1, 1000, "cpu")[1]
    assert again is not first and torch.equal(again, first)


@pytest.mark.parametrize("s", [36, 40, 17])
@pytest.mark.parametrize("form", ["int", "0-d", "(B,)"])
def test_dense_view_through_k4s_plain_version_matches_the_einsums(s, form):
    """danube's heads (32 over 8 of 120) over caches of S slots, lengths 1,
    17, a page boundary, S - 1 and S; an int, a 0-d or a (B,) length."""
    b = 2
    q, k, v = qkv(b, s, 32, 8, 120, seed=s)
    page = tpa.dense_layout(b, s, torch.device("cpu"))[0]
    for n in sorted({1, 17, page * (s // page // 2 or 1), s - 1, s}):
        if form == "int":
            lens = n
        elif form == "0-d":
            lens = torch.tensor(n)
        else:
            lens = torch.tensor([n, max(1, n - 5)], dtype=torch.int32)
        kp, vp, table, lens32 = tpa.dense_pages(k, v, lens)
        assert kp.data_ptr() == k.data_ptr() and kp.shape[1] == page
        assert lens32.dtype == torch.int32 and lens32.shape == (b,)
        got = tpa.paged_attention_ref(q, kp, vp, table, lens32)
        want = tattn.decode_attention_ref(q, k, v, lens)
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def count_paths(monkeypatch):
    """Stands the kernel entry in with its plain version (this CPU build
    cannot launch it) and counts its calls."""
    n = {"kernel": 0}

    def kernel(q, k, v, lens, sinks=None):
        n["kernel"] += 1
        return tpa.paged_attention_ref(q, *tpa.dense_pages(k, v, lens),
                                       sinks=sinks)
    monkeypatch.setattr(tattn.pa, "decode_attention", kernel)
    return n


CASES = {
    # name: (q heads, kv heads, width, q dtype, cache dtype, grad, on K4)
    "danube_bf16": (32, 8, 120, "bfloat16", "bfloat16", False, True),
    "f32": (32, 8, 120, "float32", "float32", False, True),
    "q_f32_cache_bf16": (32, 8, 120, "float32", "bfloat16", False, True),
    "recurrentgemma": (16, 1, 256, "bfloat16", "bfloat16", False, True),
    "f16": (32, 8, 120, "float16", "float16", False, False),
    "grad": (32, 8, 120, "float32", "float32", True, False),
    "too_wide": (4, 2, 592, "float32", "float32", False, False),
    "too_many_values": (16, 1, 576, "float32", "float32", False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_attention_takes_k4_only_where_it_can(monkeypatch, case):
    """With the card's condition met (a stand-in here), the dispatch runs
    K4 for f32 or bf16 at widths the kernel takes; f16, an input needing a
    gradient, a key wider than 576 or more than 8,192 values in a block of
    16 query heads keep the einsums bitwise."""
    h, kh, d, q_dt, kv_dt, grad, kernel = CASES[case]
    q, k, v = qkv(2, 24, h, kh, d, seed=d)
    q = q.to(getattr(torch, q_dt)).requires_grad_(grad)
    k, v = (x.to(getattr(torch, kv_dt)) for x in (k, v))
    lens = torch.tensor(19)
    want = tattn.decode_attention_ref(q, k, v, lens)
    monkeypatch.setattr(tattn, "_on_card", lambda *xs: True)
    counted = count_paths(monkeypatch)
    tops.reset_launches()
    got = tattn.decode_attention(q, k, v, lens)
    assert counted["kernel"] == int(kernel)
    assert tops.LAUNCHES["decode_attention_ref"] == int(not kernel)
    if kernel:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    else:
        assert torch.equal(got, want)


def test_decode_attention_keeps_the_einsums_off_the_card(monkeypatch):
    """CPU tensors and the dry run's fake CUDA tensors are not on the card:
    the einsums run, bitwise as before (on this CPU build a fake CUDA
    tensor cannot run them, so a stand-in records the call)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v = qkv(2, 24, 32, 8, 120, "bfloat16")
    assert not tattn._on_card(q, k, v)
    want = tattn.decode_attention_ref(q, k, v, 9)
    tops.reset_launches()
    assert torch.equal(tattn.decode_attention(q, k, v, 9), want)
    assert tops.LAUNCHES["decode_attention_ref"] == 1
    calls = []
    monkeypatch.setattr(tattn, "decode_attention_ref",
                        lambda q, k, v, n, sinks=None: calls.append(n) or q)
    with FakeTensorMode():
        fake = [torch.empty(x.shape, dtype=x.dtype, device="cuda")
                for x in (q, k, v)]
        assert fake[0].is_cuda and not tattn._on_card(*fake)
        tattn.decode_attention(*fake, 9)
    assert calls == [9]
    assert tops.LAUNCHES["decode_attention"] == 0


def gqa_layers(cfg) -> int:
    """Layers of `cfg` whose decode runs :func:`decode_attention`."""
    if cfg.attn_kind == "mla":
        return 0
    return sum(seg.n_periods * sum(k in ("attn", "moe") for k in seg.pattern)
               for seg in ttf.segments(cfg))


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "h2o-danube-3-4b:f32",
                                  "recurrentgemma-9b", "deepseek-v3-671b"])
def test_serve_run_counts_its_decode_attentions(arch):
    """On the CPU every GQA decode keeps the einsums (2 layers x 3 requests
    x 2 steps at danube's smoke size, recurrentgemma's one local-attention
    layer); MLA's decode is not a GQA one, and nothing launches K4's dense
    entry."""
    name, _, f32 = arch.partition(":")
    cfg = get_smoke(name)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    tops.reset_launches()
    r = tserve.run(cfg, requests=3, prefill=20, decode=2, page_size=4,
                   hbm_pages=5, device="cpu")
    assert r["logits_finite"]
    assert tops.LAUNCHES["decode_attention_ref"] == gqa_layers(cfg) * 3 * 2
    assert tops.LAUNCHES["decode_attention"] == 0
    assert gqa_layers(cfg) == {"h2o-danube-3-4b": 2, "recurrentgemma-9b": 1,
                               "deepseek-v3-671b": 0}[name]
