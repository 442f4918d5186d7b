"""The port's kernels.ops entry points K5-K7 against the JAX package, on the
CPU: the single-level LRU cache (K6) and the STREAM triad (K7) bitwise, the
blockwise attention (K5) within the JAX test's tolerances (3e-5 in f32,
3e-2 in bf16).  On CPU tensors each entry point runs its plain PyTorch
version; the JAX side runs `repro.kernels.ops` (the Pallas kernels in
interpret mode) and its oracles `repro.kernels.ref`, on the same seeded
numpy inputs.  The CUDA kernels themselves are held against these plain
versions on the card (`tests/test_torch_card.py`, `chip_smoke.py`).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops


def as_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    """numpy f32 -> torch in `dtype` (rounded as jnp.asarray rounds)."""
    return torch.from_numpy(np.array(
        jnp.asarray(x, dtype).astype(jnp.float32))).to(getattr(torch, dtype))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# K6: cache_sim
# ---------------------------------------------------------------------------
def run_cache_sim(addr: np.ndarray, n_sets: int, n_ways: int, chunk: int):
    tops.reset_launches()
    got = tops.cache_sim(torch.from_numpy(addr), n_sets=n_sets,
                         n_ways=n_ways)
    assert tops.LAUNCHES["cache_sim_ref"] == 1
    assert tops.LAUNCHES["cache_sim"] == 0
    a = jnp.asarray(addr, jnp.int32)
    pallas = jops.cache_sim(a, n_sets=n_sets, n_ways=n_ways, chunk=chunk)
    oracle = jref.cache_sim(a, n_sets, n_ways)
    for want in (pallas, oracle):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


# the JAX test's four geometries, then random traces that thrash a few sets
@pytest.mark.parametrize("n_sets,n_ways,n,chunk,span", [
    (16, 2, 256, 64, 4), (64, 4, 1024, 256, 4), (128, 8, 555, 128, 4),
    (32, 1, 333, 512, 4), (8, 16, 701, 128, 3), (2, 4, 300, 64, 6),
])
def test_cache_sim_matches_jax(n_sets, n_ways, n, chunk, span):
    rng = np.random.default_rng(n_sets * 1000 + n)
    addr = rng.integers(0, n_sets * n_ways * span, n).astype(np.int32)
    hits, tags, use = run_cache_sim(addr, n_sets, n_ways, chunk)
    assert 0 < int(hits.sum()) < n


def test_cache_sim_fills_ways_in_order_and_clocks_are_positions():
    # one set of 4 ways: lines 0, 4, 8 fill ways 0, 1, 2; 4 hits at t = 4;
    # 12 fills way 3; 16 evicts the least recent (0, way 0); 0 then evicts
    # 8 (way 2, last used at t = 3)
    addr = np.array([0, 4, 8, 4, 12, 16, 0], np.int32)
    hits, tags, use = run_cache_sim(addr, 4, 4, 8)
    assert hits.tolist() == [0, 0, 0, 1, 0, 0, 0]
    assert tags[0].tolist() == [16, 4, 0, 12]
    assert use[0].tolist() == [6, 4, 7, 5]
    assert tags[1:].eq(-1).all() and use[1:].eq(0).all()


def test_cache_sim_rejects_negative_addresses_and_records_the_split():
    """The Pallas body skips negative addresses as padding (`valid = a >=
    0`); its oracle treats them as live lines.  The port raises on them,
    for the kernel and the plain version alike."""
    addr = np.array([5, -3, 5, 21, -3], np.int32)
    a = jnp.asarray(addr)
    pallas = jops.cache_sim(a, n_sets=16, n_ways=2, chunk=8)
    oracle = jref.cache_sim(a, 16, 2)
    assert np.asarray(pallas[0]).tolist() == [0, 0, 1, 0, 0]
    assert np.asarray(oracle[0]).tolist() == [0, 0, 1, 0, 1]
    assert not np.array_equal(np.asarray(pallas[1]), np.asarray(oracle[1]))
    # the wrapper checks before it picks the kernel or the plain version
    with pytest.raises(ValueError, match="negative"):
        tops.cache_sim(torch.from_numpy(addr), n_sets=16, n_ways=2)
    with pytest.raises(TypeError, match="int32"):
        tops.cache_sim(torch.tensor([1, 2]), n_sets=16, n_ways=2)
    with pytest.raises(ValueError, match="power of two"):
        tops.cache_sim(torch.zeros(4, dtype=torch.int32), n_sets=12,
                       n_ways=2)
    empty = tops.cache_sim(torch.zeros(0, dtype=torch.int32), n_sets=4,
                           n_ways=2)
    assert empty[0].shape == (0,) and bool((empty[1] == -1).all())


# ---------------------------------------------------------------------------
# K7: stream_triad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype,s", [
    ((8, 128), "float32", 2.5), ((32, 256), "float32", 2.5),
    ((16, 128), "bfloat16", 2.5), ((64, 512), "float32", 2.5),
    ((64, 512), "bfloat16", 0.1), ((8, 1000), "float32", 0.1),
])
def test_stream_triad_matches_jax(shape, dtype, s):
    """Bitwise against the jnp oracle in both types; against the Pallas
    op in interpret mode bitwise in bf16 and within the JAX test's 1e-5 in
    f32, where XLA's CPU backend fuses the body into one multiply-add (it
    equals the float64 evaluation of b + s * c rounded once)."""
    rng = np.random.default_rng(shape[0] + shape[1])
    b = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    tops.reset_launches()
    got = tops.stream_triad(as_torch(b, dtype), as_torch(c, dtype), s)
    assert tops.LAUNCHES["stream_triad_ref"] == 1
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    jb, jc = jnp.asarray(b, dtype), jnp.asarray(c, dtype)
    oracle = to_np(jref.stream_triad(jb, jc, s))
    pallas = to_np(jops.stream_triad(jb, jc, s))
    np.testing.assert_array_equal(to_np(got), oracle)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(to_np(got), pallas)
    else:
        np.testing.assert_allclose(to_np(got), pallas, rtol=1e-5, atol=1e-5)
        s32 = np.float32(s)
        fused = (b.astype(np.float64) + np.float64(s32) * c).astype(
            np.float32)
        np.testing.assert_array_equal(pallas, fused)


@pytest.mark.parametrize("tool", ["k5_variants", "k7_variants",
                                  "mesi_variants", "k4k6_variants"])
def test_variant_tools_match_their_sources(tool):
    """The design-variant tools still fit the sources they build: every
    named edit of K5's and of the MESI kernels' applies to the committed
    sources once, and K7's variant names cover its study kernel's launch
    table."""
    import importlib.util
    root = pathlib.Path(__file__).resolve().parent.parent / "tools"
    spec = importlib.util.spec_from_file_location(tool, root / f"{tool}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if tool == "k5_variants":
        texts = mod.sources()
        assert list(texts) == [name for name, _, _ in mod.VARIANTS]
        assert texts["committed"] == (mod.CSRC / "flash_attention.cu"
                                      ).read_text()
        assert len(set(texts.values())) == len(texts)
    elif tool == "mesi_variants":
        from repro_torch.core.cache import CacheParams
        from repro_torch.kernels import build, cache_sim
        texts = mod.sources()
        assert list(texts) == [name for name, _, _ in mod.VARIANTS]
        assert texts["committed"] == {f: (mod.CSRC / f).read_text()
                                      for f in mod.FILES}
        assert len({tuple(t.values()) for t in texts.values()}) == len(texts)
        # the variants' library sources: every quoted include is copied
        for lib in ("mesi", "mesi_dyn"):
            assert {p.name for p in build.sources(lib)} <= set(mod.FILES)
        assert cache_sim.chain_bits(CacheParams()) == 7     # 128 chains
    elif tool == "k4k6_variants":
        from repro_torch.kernels import build, cache_sim, paged_attention
        texts = mod.sources()
        assert list(texts) == [name for name, *_ in mod.VARIANTS]
        assert texts["committed"] == {f: (mod.CSRC / f).read_text()
                                      for f in mod.FILES}
        modules = {"cache_sim": cache_sim, "paged_attention": paged_attention}
        for name, kernel, _, edits, py in mod.VARIANTS[1:]:
            assert kernel in ("K4", "K6") and (edits or py)
            assert (texts[name] != texts["committed"]) == bool(edits)
            for module, attr in py:
                assert hasattr(modules[module], attr)
        for lib in mod.LIBS:
            assert {p.name for p in build.sources(lib)} <= set(mod.FILES)
    else:
        cu = (root / "k7_variants.cu").read_text()
        table = cu[cu.index("constexpr Config kConfigs[] = {"):]
        table = table[:table.index("};")]
        assert table.count("{") - 1 == len(mod.VARIANTS)
        for name in mod.VARIANTS:
            assert f"// {name}" in table or f", {name}" in table


def test_stream_triad_keeps_the_jax_contract():
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="equal-shape 2-D"):
        tops.stream_triad(x, torch.zeros((8, 8)), 1.0)
    with pytest.raises(ValueError, match="equal-shape 2-D"):
        tops.stream_triad(x[0], x[0], 1.0)
    with pytest.raises(ValueError, match="block multiple"):
        tops.stream_triad(torch.zeros((12, 16)), torch.zeros((12, 16)), 1.0)
    # s is rounded to the arrays' type first: 0.1 in bf16 is 0.10009765625
    one = torch.ones((8, 4), dtype=torch.bfloat16)
    got = tops.stream_triad(torch.zeros_like(one), one, 0.1)
    assert float(got[0, 0]) == 0.10009765625


# ---------------------------------------------------------------------------
# K5: flash_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,sq,sk,d,win,causal,dtype", [
    # the five cases of the JAX test
    (2, 4, 128, 128, 64, None, True, "float32"),
    (1, 2, 128, 256, 64, None, True, "float32"),
    (2, 4, 256, 256, 64, 64, True, "float32"),
    (1, 2, 128, 128, 128, None, True, "bfloat16"),
    (1, 8, 384, 384, 32, 128, True, "float32"),
    # danube's head width, rows with no key (Sq > Sk), non-causal, a window
    # shorter than a tile and one longer than the sequence
    (1, 2, 128, 128, 120, None, True, "float32"),
    (1, 2, 256, 128, 120, None, True, "float32"),
    (1, 2, 128, 256, 64, None, False, "float32"),
    (1, 2, 256, 256, 64, 20, True, "bfloat16"),
    (1, 2, 128, 128, 32, 1000, True, "float32"),
])
def test_flash_attention_matches_jax(b, h, sq, sk, d, win, causal, dtype):
    rng = np.random.default_rng(b * h * sq + sk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    tops.reset_launches()
    got = tops.flash_attention(*(as_torch(x, dtype) for x in (q, k, v)),
                               causal=causal, window=win)
    assert tops.LAUNCHES["flash_attention_ref"] == 1
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, sq, d)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    want = [jref.flash_attention(jq, jk, jv, causal=causal, window=win)]
    if causal:      # the Pallas op's own test runs it causal only
        want.append(jops.flash_attention(jq, jk, jv, causal=True,
                                         window=win))
    for w in want:
        np.testing.assert_allclose(to_np(got), to_np(w), rtol=tol, atol=tol)
    if sq > sk and causal:          # rows before the first key see none
        assert not to_np(got)[:, :, :sq - sk].any()


@pytest.mark.parametrize("dtype,d,want", [
    ("bfloat16", 120, "tensor_cores"), ("bfloat16", 128, "tensor_cores"),
    ("bfloat16", 16, "tensor_cores"), ("bfloat16", 8, "tensor_cores"),
    ("bfloat16", 12, "cuda_cores"), ("bfloat16", 100, "cuda_cores"),
    ("float32", 120, "cuda_cores"), ("float32", 64, "cuda_cores"),
])
def test_flash_attention_variant_follows_dtype_and_head_dim(dtype, d, want):
    """bf16 with D % 8 == 0 goes to the tensor cores; f32, and bf16 at any
    other D, to the CUDA cores: a function of (dtype, D) alone."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.variant(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("dtype,d,dv,sinks,want", [
    ("bfloat16", 192, 128, False, "tensor_cores_own_v"),   # MiMo full
    ("bfloat16", 192, 128, True, "tensor_cores_own_v"),    # MiMo window
    ("bfloat16", 24, 16, True, "tensor_cores_own_v"),      # MiMo smoke
    ("bfloat16", 120, 120, True, "tensor_cores_own_v"),    # sinks alone
    ("bfloat16", 64, 128, False, "tensor_cores_own_v"),    # v wider
    ("bfloat16", 120, 120, False, "tensor_cores"),         # danube
    ("bfloat16", 200, 128, False, "cuda_cores"),           # q past 192
    ("bfloat16", 192, 136, False, "cuda_cores"),           # v past 128
    ("bfloat16", 192, 132, False, "cuda_cores"),           # v % 8 != 0
    ("bfloat16", 256, 256, False, "cuda_cores"),           # D = 256
    ("float32", 192, 128, True, "cuda_cores"),
])
def test_flash_attention_variant_follows_the_widths_and_sinks(dtype, d, dv,
                                                              sinks, want):
    """The tensor-core kernel's second form takes bf16 q / k up to 192 and
    v up to 128 wide (multiples of 8) where v's width differs from q's or
    there are sinks; the first form keeps v as wide as q, D <= 128 and no
    sinks; the rest goes to the CUDA cores (which refuse what they do not
    take)."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.variant(getattr(torch, dtype), d, dv, sinks) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_on_cpu_tensors_launches_no_variant(dtype):
    """A CPU q runs the plain version and counts neither kernel variant."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.ones((1, 2, 128, 120), dtype=getattr(torch, dtype))
    tops.reset_launches()
    fa.reset_variant_launches()
    got = tops.flash_attention(q, q, q, window=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert tops.LAUNCHES["flash_attention_ref"] == 1
    assert tops.LAUNCHES["flash_attention"] == 0
    assert fa.VARIANT_LAUNCHES == {"tensor_cores": 0,
                                   "tensor_cores_own_v": 0, "cuda_cores": 0}


def test_flash_attention_keeps_the_jax_contract():
    q = torch.zeros((1, 2, 128, 16))
    with pytest.raises(ValueError, match="block multiples"):
        tops.flash_attention(q, torch.zeros((1, 2, 200, 16)),
                             torch.zeros((1, 2, 200, 16)))
    with pytest.raises(ValueError, match="block multiples"):
        tops.flash_attention(torch.zeros((1, 2, 130, 16)), q, q)
    with pytest.raises(ValueError, match="differ"):
        tops.flash_attention(q, q, torch.zeros((1, 2, 64, 16)))
    with pytest.raises(ValueError, match="multiple of K"):
        tops.flash_attention(q, torch.zeros((1, 3, 128, 16)),
                             torch.zeros((1, 3, 128, 16)))
    with pytest.raises(ValueError, match="sinks"):
        tops.flash_attention(q, q, q, sinks=torch.zeros(3))
    # v may be narrower than q and k, and KV heads fewer than query heads
    kv = torch.zeros((1, 1, 128, 16))
    assert tops.flash_attention(q, kv, torch.zeros((1, 1, 128, 8)),
                                sinks=torch.zeros(2)).shape == (1, 2, 128, 8)
    # a sequence shorter than the tile is its own tile
    short = torch.ones((1, 1, 24, 8))
    assert tops.flash_attention(short, short, short).shape == (1, 1, 24, 8)


def test_flash_attention_live_pairs_and_bound():
    from repro_torch.kernels import flash_attention as fa
    assert fa.live_pairs(4096, 4096) == 4096 * 4097 // 2
    assert fa.live_pairs(8192, 8192, window=4096) == 25_167_872
    assert fa.live_pairs(4, 2) == 3            # rows 0, 1 see no key
    assert fa.live_pairs(2, 4, causal=False) == 8
    q = torch.empty((1, 32, 4096, 120), dtype=torch.bfloat16)
    ms, by, n_bytes, flops = fa.bound_ms(q, q, window=4096)
    assert flops == 4 * 32 * 120 * 8_390_656 and by == "operations"
    assert n_bytes == 4 * q.numel() * 2
    assert abs(ms - flops / 989e12 * 1e3) < 1e-12
    # in f32 the CUDA cores' 67 TFLOP/s set the bound
    ms32, by32, _, _ = fa.bound_ms(q.float(), q.float(), window=4096)
    assert by32 == "operations" and abs(ms32 - flops / 67e12 * 1e3) < 1e-12
    # MiMo's full layer: 2 x (192 + 128) flops a live pair, v's own bytes
    q = torch.empty((1, 64, 4096, 192), dtype=torch.bfloat16)
    k = torch.empty((1, 4, 4096, 192), dtype=torch.bfloat16)
    v = torch.empty((1, 4, 4096, 128), dtype=torch.bfloat16)
    ms, by, n_bytes, flops = fa.bound_ms(q, k, v=v)
    assert flops == 2 * (192 + 128) * 64 * 8_390_656 and by == "operations"
    assert n_bytes == 2 * (q.numel() + k.numel() + v.numel()
                           + 64 * 4096 * 128)
