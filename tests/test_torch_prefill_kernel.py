"""The GQA prefill's attention on K5, checked on the CPU.

:func:`repro_torch.models.attention.gqa_flash_attention` (heads broadcast,
a ragged S padded at the tail) against :func:`blockwise_attention`,
through K5's plain version, which ``flash_attention`` runs on CPU tensors:
within 2e-5 in float32 and 3e-2 in bf16 (the JAX test's K5 tolerances
widened to the loop's own rounding of q and p), at danube's widths and at
MiMo-V2-Flash's (q and k 192, v 128, window layers with sinks).  Then the
dispatch of :func:`prefill_attention`, as a predicate on shapes and flags
and through the function: every input that no tensor-core form of K5
takes keeps the loop bitwise; and the paths ``serve.run``'s prefills
take.  The card's side is in ``tests/test_torch_card.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn


def qkv(s, n, kh, d, dtype, seed=0, dv=None):
    g = torch.Generator().manual_seed(seed)
    shapes = ((1, s, n, d), (1, s, kh, d), (1, s, kh, dv or d))
    return [torch.randn(sh, generator=g).to(getattr(torch, dtype))
            for sh in shapes]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("s", [96, 200, 1000, 1100])
def test_gqa_flash_attention_matches_blockwise(s, window, dtype, tol):
    """danube's GQA (32 query heads over 8 KV heads of 120): K5's plain
    version on the broadcast heads, S padded to K5's tile above it."""
    q, k, v = qkv(s, 32, 8, 120, dtype, seed=s)
    tops.reset_launches()
    got = tattn.gqa_flash_attention(q, k, v, window=window)
    assert tops.LAUNCHES["flash_attention_ref"] == 1
    want = tattn.blockwise_attention(q, k, v, causal=True, window=window)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


MIMO_SHAPES = {
    # name: (S, query heads, KV heads, window, sinks)
    "full": (256, 8, 2, None, False),
    "window_sinks": (256, 8, 4, 16, True),
    "ragged": (200, 8, 4, 16, True),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("shape", list(MIMO_SHAPES))
def test_gqa_flash_attention_matches_blockwise_at_mimo_widths(shape, dtype,
                                                              tol):
    """MiMo-V2-Flash's widths (q and k 192, v 128) at a smoke head count:
    K5's plain version (KV heads read in place, sinks as one more logit
    with no value) against the loop, over a full layer, a window layer with
    sinks and a ragged S padded to K5's tile."""
    s, n, kh, window, with_sinks = MIMO_SHAPES[shape]
    q, k, v = qkv(s, n, kh, 192, dtype, seed=s + kh, dv=128)
    sinks = (torch.log(torch.tensor(128.0)) + torch.randn(
        n, generator=torch.Generator().manual_seed(1))) if with_sinks \
        else None
    tops.reset_launches()
    got = tattn.gqa_flash_attention(q, k, v, window=window, sinks=sinks)
    assert tops.LAUNCHES["flash_attention_ref"] == 1
    assert tops.LAUNCHES["flash_attention_sinks_ref"] == int(with_sinks)
    want = tattn.blockwise_attention(q, k, v, causal=True, window=window,
                                     sinks=sinks)
    assert got.shape == want.shape == (1, s, n, 128)
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_ref_with_sinks_gives_0_to_rows_with_no_key():
    """Sq > Sk: the first rows see no key; with sinks they still give 0, as
    the loop and K5 give them."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 4, 256, 24), generator=g)
    k = torch.randn((1, 2, 128, 24), generator=g)
    v = torch.randn((1, 2, 128, 16), generator=g)
    got = fa.flash_attention_ref(q, k, v, sinks=torch.ones(4))
    assert not got[:, :, :128].any() and got[:, :, 128:].abs().sum() > 0


PREFILL_ROUTES = {
    # name: (dtype, hd, hd_v, sinks, taken by K5 with no gradient)
    "mimo_full": ("bfloat16", 192, 128, False, True),
    "mimo_window": ("bfloat16", 192, 128, True, True),
    "mimo_smoke": ("bfloat16", 24, 16, True, True),
    "danube": ("bfloat16", 120, 120, False, True),
    "mla": ("bfloat16", 192, 128, False, True),
    "mimo_f32": ("float32", 192, 128, True, False),
    "mixed": (None, 192, 128, False, False),
    "d256": ("bfloat16", 256, 256, False, False),
}


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("case", list(PREFILL_ROUTES))
def test_prefill_on_k5_decides_from_shapes_and_flags(case, grad):
    """The routing of :func:`prefill_attention` as a predicate on the
    inputs' type, widths, sinks and flags: MiMo's layers (hd 192 / v 128,
    with and without sinks), danube's and MLA's widths go to K5 on the
    card with no gradient; f32, mixed types, D = 256, an input needing a
    gradient or one off the card keep the loop.  (MLA's prefill calls the
    loop itself, with YaRN's scale.)"""
    dtype, hd, hd_v, sinks, taken = PREFILL_ROUTES[case]
    dtype = dtype and getattr(torch, dtype)
    for on_card in (False, True):
        assert tattn.prefill_on_k5(
            dtype, hd, hd_v, sinks=sinks, on_card=on_card,
            needs_grad=grad) == (taken and on_card and not grad)


def count_paths(monkeypatch):
    """Counts :func:`prefill_attention`'s calls by path from here on: on K5
    (``kernel``, through :func:`gqa_flash_attention`) or the loop."""
    n = {"kernel": 0, "blockwise": 0}
    real_pa, real_gqa = tattn.prefill_attention, tattn.gqa_flash_attention

    def gqa(*args, **kw):
        n["kernel"] += 1
        return real_gqa(*args, **kw)

    def pa(*args, **kw):
        k0 = n["kernel"]
        out = real_pa(*args, **kw)
        n["blockwise"] += n["kernel"] == k0
        return out
    monkeypatch.setattr(tattn, "gqa_flash_attention", gqa)
    monkeypatch.setattr(tattn, "prefill_attention", pa)
    return n


CASES = {
    # name: (q/k width, v width, dtype, requires grad, taken by K5, sinks)
    "kernel": (120, 120, "bfloat16", False, True, False),
    "grad": (120, 120, "bfloat16", True, False, False),
    "f32": (120, 120, "float32", False, False, False),
    "mla_192_128": (192, 128, "bfloat16", False, True, False),
    "mimo_sinks": (192, 128, "bfloat16", False, True, True),
    "mimo_sinks_grad": (192, 128, "bfloat16", True, False, True),
    "mimo_sinks_f32": (192, 128, "float32", False, False, True),
    "d256": (256, 256, "bfloat16", False, False, False),
    "d12": (12, 12, "bfloat16", False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_attention_takes_k5_only_where_it_can(monkeypatch, case):
    """With the card's condition met (a stand-in here), the dispatch runs
    K5 for bf16 with D % 8 == 0 and either D <= 128, v as wide as q and no
    sinks, or D <= 192 and v <= 128 (sinks or not); anything else, or an
    input needing a gradient, keeps the loop bitwise."""
    d, dv, dtype, grad, kernel, with_sinks = CASES[case]
    q, k, v = qkv(40, 4, 2, d, dtype, dv=dv)
    sinks = torch.linspace(-1.0, 2.0, 4) if with_sinks else None
    for x in (q, k, v):
        x.requires_grad_(grad)
    monkeypatch.setattr(tattn, "_on_card", lambda *xs: True)
    if kernel:
        want = tattn.gqa_flash_attention(q, k, v, window=16, sinks=sinks)
    else:
        want = tattn.blockwise_attention(q, k, v, window=16, kv_chunk=16,
                                         sinks=sinks)
    counted = count_paths(monkeypatch)
    got = tattn.prefill_attention(q, k, v, window=16, kv_chunk=16,
                                  sinks=sinks)
    assert counted == {"kernel": int(kernel), "blockwise": int(not kernel)}
    assert torch.equal(got, want)


def test_prefill_attention_keeps_the_loop_off_the_card(monkeypatch):
    """CPU tensors and the dry run's fake CUDA tensors are not on the
    card: the loop runs (on this CPU build a fake CUDA tensor cannot run
    it, so a stand-in records the call)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v = qkv(40, 4, 2, 16, "bfloat16")
    assert not tattn._on_card(q, k, v)
    want = tattn.blockwise_attention(q, k, v, kv_chunk=16)
    counted = count_paths(monkeypatch)
    assert torch.equal(tattn.prefill_attention(q, k, v, kv_chunk=16), want)
    calls = []
    monkeypatch.setattr(tattn, "blockwise_attention",
                        lambda q, k, v, **kw: calls.append(kw) or q)
    with FakeTensorMode():
        fake = [torch.empty(x.shape, dtype=x.dtype, device="cuda")
                for x in (q, k, v)]
        assert fake[0].is_cuda and not tattn._on_card(*fake)
        tattn.prefill_attention(*fake, window=8, kv_chunk=16)
    assert calls == [{"causal": True, "window": 8, "kv_chunk": 16,
                      "sinks": None}]
    assert counted == {"kernel": 0, "blockwise": 2}


@pytest.mark.parametrize("arch,want", [
    ("h2o-danube-3-4b", {"kernel": 0, "blockwise": 2 * 3}),
    ("h2o-danube-3-4b:f32", {"kernel": 0, "blockwise": 2 * 3}),
    ("deepseek-v3-671b", {"kernel": 0, "blockwise": 3 * 3}),
    ("mimo-v2-flash-309b", {"kernel": 0, "blockwise": 4 * 3}),
    ("kimi-linear-48b-a3b", {"kernel": 0, "blockwise": 1 * 3})])
def test_serve_run_counts_its_prefill_attentions(monkeypatch, arch, want):
    """On the CPU every GQA prefill keeps the loop (2 layers x 3 requests
    at danube's smoke size, 4 at MiMo's), and so does an MLA prefill at
    the plain softmax scale, which takes the same dispatch (deepseek's
    smoke config, without YaRN: 3 layers; Kimi-Linear's: its one MLA
    layer; its KDA layers have no attention)."""
    name, _, f32 = arch.partition(":")
    cfg = get_smoke(name)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    counted = count_paths(monkeypatch)
    r = tserve.run(cfg, requests=3, prefill=20, decode=2, page_size=4,
                   hbm_pages=5, device="cpu")
    assert r["logits_finite"] and counted == want
