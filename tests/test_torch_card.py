"""The CUDA kernels on the card: the MESI kernels against their plain
versions, bitwise; paged attention (K4) against its plain version within
rtol = atol = 3e-5 (f32 pools and queries) or 2e-2 (bf16: the kernel and
the plain version round the bf16 output of the same f32 sums; one bf16
ulp at |x| < 2 is 7.8e-3 or less), and the serving loop on the card; the
single-level LRU cache (K6) and the STREAM triad (K7)
bitwise, and the blockwise attention (K5, both kernel variants) within the
JAX test's 3e-5 (f32) or 3e-2 (bf16), and on a (1, 4, 1024, 120) bf16 case
within the main path's 5e-3 and an error RMS of 1e-3 of the output's.
The training loop and the MoE block (no kernel on their path) run on the
card as on the CPU in float32: losses within rtol 1e-4, MoE outputs
within 1e-5; so do the rwkv, rec and MLA kinds (logits within 1e-4,
gradients within rtol 1e-4 and 1e-4 of each leaf's largest entry), and
K4 at their serve shapes (D = 64, 256 with 16 groups, 192 with 128
heads) within its tolerances.  The CXL.mem flit codec runs on the card
bitwise as on the CPU, and the dry run on fake CUDA tensors counts the
FLOPs of the same step run on the card.  The analyzer's graph audit is
clean on the card, where it traces the kernel entry points and
triangulates the MESI and epoch kernels against the reference, and that
triangulation catches a kernel whose counters come out reordered.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports no JAX, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import route as troute
from repro_torch.core import tiering_dyn as tdyn
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import LatencyDistribution, TimingConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import cache_sim as tkernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import stream_triad as ttriad
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch import tree as ttree
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.workloads import HotCold

pytestmark = pytest.mark.cuda

SMALL = dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MESI kernel runs only on the card")
    return torch.device("cuda")


def batch(seed, n, cores, n_targets, device):
    """Thrashing, hit-heavy, sentinel-tailed and write-only rows."""
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, 512, (4, n)).astype(np.int32)
    addr[1] = rng.integers(0, 24, n)
    addr[2, n - n // 5:] = tcache.SENTINEL
    wr = rng.integers(0, 2, (4, n)).astype(np.int32)
    wr[3] = 1
    core = rng.integers(0, cores, (4, n)).astype(np.int32)
    tier = rng.integers(0, n_targets, (4, n)).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (addr, wr, core, tier)]


def assert_same(a, b):
    (sa, sta), (sb, stb) = a, b
    assert torch.equal(sa, sb)
    for f in sta._fields:
        assert torch.equal(getattr(sta, f), getattr(stb, f)), f


@pytest.mark.parametrize("cores,n_targets", [(1, 2), (2, 3), (4, 5)])
def test_kernel_matches_plain_version(card, cores, n_targets):
    p = tcache.CacheParams(**SMALL, cores=cores, n_targets=n_targets)
    trace = batch(cores, 700, cores, n_targets, card)
    tops.reset_launches()
    kern = tkernels.mesi_cache_sim(*trace, params=p)
    plain = tkernels.mesi_cache_sim(*trace, params=p, backend="reference")
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  mesi_segment=1, mesi_segment_ref=1)
    assert_same(kern, plain)


def test_segments_alternate_between_kernel_and_plain(card):
    p = tcache.CacheParams(**SMALL, cores=2, n_targets=3)
    trace = batch(5, 600, 2, 3, card)
    want = tkernels.mesi_cache_sim(*trace, params=p)
    carry = tcache.init_batch_carry(p, 4, device=card)
    for i, s in enumerate(range(0, 600, 150)):
        carry = tkernels.mesi_segment(
            carry, *[x[:, s:s + 150].contiguous() for x in trace], params=p,
            backend="reference" if i % 2 else "cuda")
    assert torch.equal(carry[3], torch.full_like(carry[3], 601))
    assert_same((carry[2], tcache.unpack_state(carry[0], carry[1])), want)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    p = tcache.CacheParams(**SMALL, cores=2)
    addr, wr, core, tier = batch(1, 64, 2, 2, card)
    carry = tcache.init_batch_carry(p, 4, device=card)
    with pytest.raises(TypeError, match="int32"):
        tkernels._launch(carry, addr.long(), wr, core, tier, p)
    with pytest.raises(ValueError, match="contiguous"):
        tkernels._launch(carry, addr.t().contiguous().t(), wr, core, tier, p)
    with pytest.raises(ValueError, match="shape"):
        tkernels._launch(carry, addr[:2], wr[:2], core[:2], tier[:2], p)
    with pytest.raises(ValueError, match="core ids"):
        tkernels.mesi_segment(carry, addr, wr, core + 1, tier, params=p)


def test_main_path_runs_on_the_kernel(card):
    p = tcache.CacheParams(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024,
                           l2_ways=8)
    spec = tengine.SweepSpec(
        footprint_factors=(1, 2),
        policies=(tnuma.ZNuma(0.0), tnuma.WeightedInterleave(1, 1)),
        cpus=(CPUModel(kind="inorder"), CPUModel(kind="o3")))
    tops.reset_launches()
    on_card = tengine.run_sweep(spec, p, TimingConfig())
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  mesi_segment=1)
    assert on_card == tengine.run_sweep(spec, p, TimingConfig(), device="cpu")


def dyn_batch(seed, n_p, device, n=512, cores=2, n_targets=3):
    """A two-tier row under DRAM pressure, a sampled row whose budget
    exceeds the page count, a three-tier row (with two targets, another
    two-tier row) and a static row with a sentinel tail (the CPU tests'
    batch, built here without JAX)."""
    rng = np.random.default_rng(seed)
    b, unbounded = 4, tdyn.UNBOUNDED_PAGES
    addr = np.where(rng.random((b, n)) < 0.6,
                    rng.integers(0, 64 * min(n_p, 4), (b, n)),
                    rng.integers(0, 64 * n_p, (b, n))).astype(np.int32)
    addr[3, n - 40:] = tcache.SENTINEL
    trace = [torch.from_numpy(x).to(device) for x in (
        addr, rng.integers(0, 2, (b, n)).astype(np.int32),
        rng.integers(0, cores, (b, n)).astype(np.int32),
        rng.integers(1, n_targets, (b, n)).astype(np.int32))]
    pmap0 = rng.integers(0, 2, (b, n_p)).astype(np.int32)
    ssd = n_targets > 2
    if ssd:
        pmap0[2, :2] = 2
    kw = dict(slot_len=32, k_max=8, page_map0=torch.from_numpy(pmap0),
              dyn_flag=[1, 1, 1, 0], n_pages=[n_p, n_p - 1, n_p, n_p],
              budget=[2, n_p + 3, 3, 0], threshold=[1, 2, 1, 1],
              period=[1, 2, 1, 1], dram_cap=[3, 2, unbounded, unbounded],
              page_target_lines=torch.from_numpy(rng.integers(
                  0, 40, (b, n_p, n_targets)).astype(np.int32)),
              ssd_tid=[0, 0, n_targets - 1 if ssd else 0, 0],
              cxl_cap=[unbounded, unbounded, 2 if ssd else unbounded,
                       unbounded],
              s_warm=[0, 1, 0, 0], s_meas=[0, 1, 0, 0], s_per=[0, 3, 0, 0])
    return trace, kw


# 12 pages keep the page map and counts in shared memory; 30,000 (240 KB)
# push them to global memory.  Two targets is the layout of every sweep
# without a topology axis (12 stats, a (B, P, 2) page table).
@pytest.mark.parametrize("n_p,n_targets", [(12, 3), (30_000, 3), (12, 2)])
def test_dyn_kernel_matches_plain_version(card, n_p, n_targets):
    p = tcache.CacheParams(**SMALL, cores=2, n_targets=n_targets)
    trace, kw = dyn_batch(n_p, n_p, card, n_targets=n_targets)
    tops.reset_launches()
    kern = tdyn.run_dynamic(p, *trace, **kw)
    plain = tdyn.run_dynamic(p, *trace, backend="reference", **kw)
    assert tops.LAUNCHES["mesi_dyn_segment"] == 1
    assert tops.LAUNCHES["mesi_dyn_segment_ref"] == 1
    for field in kern._fields:
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field
    assert kern.slots[:3, :, 2:].sum() > 0
    # the kernel in segments of 5 slots, threading the carry
    segmented = tdyn.run_dynamic(p, *trace, segment_slots=5, **kw)
    for field in kern._fields:
        assert torch.equal(getattr(segmented, field), getattr(kern, field))


# The chain split's edge cases: L1 sets equal to L2 sets (16 each); one L1
# set (m = 1: one chain per row, the Table-I L2's planes in global memory);
# every access in one chain of the golden geometry (the worst imbalance);
# 31 cores with the Table-I L1 over a 4-set L2 (4 chains of 31 x 32 L1
# sets, 381 KB a block: the L1 sets in global memory, where the block's
# 4 warps write disjoint cells).  Each case's cores, and where its chains
# keep their L1 and L2 sets (1: shared memory).
SPLIT = {
    "equal": (dict(l1_bytes=2048, l1_ways=2, l2_bytes=8192, l2_ways=8),
              2, (1, 1)),
    "one_set": (dict(l1_bytes=512, l1_ways=8), 2, (1, 0)),
    "one_chain": (dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024,
                       l2_ways=8), 2, (1, 1)),
    "l1_global": (dict(l2_bytes=4 * 16 * 64, l2_ways=16), 31, (0, 1)),
}


def split_params(case):
    kw, cores, layout = SPLIT[case]
    return tcache.CacheParams(**kw, cores=cores, n_targets=3), layout


def into_one_chain(addr, p, chain=3):
    m = 1 << tkernels.chain_bits(p)
    return torch.where(addr == tcache.SENTINEL, addr, addr // m * m + chain)


@pytest.mark.parametrize("case", list(SPLIT))
def test_chain_split_kernel_matches_plain_version(card, case):
    p, layout = split_params(case)
    plan = tkernels.mesi_plan(p, card)
    assert (plan["l1_in_smem"], plan["l2_in_smem"]) == layout
    assert plan["warps_per_block"] == min(4, 1 << plan["bits"])
    addr, wr, core, tier = batch(11, 900, p.cores, 3, card)
    addr = torch.where(addr == tcache.SENTINEL, addr, addr - 40)  # negatives
    if case == "one_chain":
        addr = into_one_chain(addr, p)
    trace = [addr, wr, core, tier]
    want = tkernels.mesi_cache_sim(*trace, params=p, backend="reference")
    assert_same(tkernels.mesi_cache_sim(*trace, params=p), want)


@pytest.mark.parametrize("case", list(SPLIT))
def test_chain_split_dyn_kernel_matches_plain_version(card, case):
    """The batch holds a sampled row with period 2 and a three-tier row
    (the SSD stage)."""
    p, layout = split_params(case)
    plan = tkernels.mesi_dyn_plan(p, 4, 12, card, meet=True)
    assert (plan["l1_in_smem"], plan["l2_in_smem"]) == layout
    trace, kw = dyn_batch(21, 12, card, cores=p.cores)
    if case == "one_chain":
        trace[0] = into_one_chain(trace[0], p)
    kern = tdyn.run_dynamic(p, *trace, **kw)
    plain = tdyn.run_dynamic(p, *trace, backend="reference", **kw)
    for field in kern._fields:
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field
    assert bool((kern.slots[:3, :, 2:].sum(dim=(1, 2)) > 0).all())


def test_dyn_kernel_splits_rows_over_cooperative_launches(card):
    """More migrating rows than the card holds at once: the plan runs them
    in several cooperative launches."""
    p, _ = split_params("one_chain")
    trace, kw = dyn_batch(5, 12, card, n=128)
    b, pick = 320, torch.arange(320) % 4
    trace = [x[pick.to(card)].contiguous() for x in trace]
    kw = {k: (v[pick] if isinstance(v, torch.Tensor)
              else [v[i] for i in pick.tolist()] if isinstance(v, list)
              else v) for k, v in kw.items()}
    plan = tkernels.mesi_dyn_plan(p, b, 12, card, meet=True)
    assert plan["rows_per_launch"] < b
    kern = tdyn.run_dynamic(p, *trace, **kw)
    plain = tdyn.run_dynamic(p, *trace, backend="reference", **kw)
    for field in kern._fields:
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field


def test_fidelity_golden_on_the_card(card):
    golden = pathlib.Path(__file__).resolve().parent / "golden"
    spec = tengine.SweepSpec(
        footprint_factors=(8,), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),),
        workloads=(HotCold(hot_page_frac=0.25),),
        topologies=(troute.direct(1, ssd_gib=16),),
        tiering=(tdyn.DynamicTiering(epoch_len=2048, budget=16, threshold=8,
                                     cxl_capacity_pages=8),),
        distributions=(None, LatencyDistribution(n_samples=128, seed=0)))
    tops.reset_launches()
    rows = tengine.run_sweep(spec, tcache.CacheParams(
        l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8),
        TimingConfig())
    assert tops.LAUNCHES["mesi_dyn_segment"] == 1
    assert tops.LAUNCHES["mesi_dyn_segment_ref"] == 0
    assert json.loads(json.dumps(rows)) == json.loads(
        (golden / "fidelity.json").read_text())


GOLDEN_GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024,
                       l2_ways=8)


def test_segment_calls_keep_their_input_carry_on_the_card(card):
    """The resilient executor retries and halves from the carry it passed
    in: K2 and K3 must leave it as it was."""
    p = tcache.CacheParams(**SMALL, cores=2, n_targets=3)
    trace, kw = dyn_batch(12, 12, card, n_targets=3)
    carry = tcache.init_batch_carry(p, 4, device=card)
    before = [x.clone() for x in carry]
    tkernels.mesi_segment(carry, *trace, params=p)
    assert all(torch.equal(a, b) for a, b in zip(before, carry))
    a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
        tdyn.prep_dynamic_inputs(*trace, **kw)
    dcarry = tdyn.init_dyn_carry(p, pmap0)
    before = [x.clone() for x in dcarry]
    tdyn.run_dynamic_segment(p, k_max, bound, dcarry, a3, w3, c3, t3,
                             *scalars)
    assert all(torch.equal(a, b) for a, b in zip(before, dcarry))


def test_padding_rows_on_the_card(card):
    """Shard padding rows, all sentinel from their first access, through
    K2: bitwise the plain version, zero stats, state untouched."""
    p = tcache.CacheParams(**GOLDEN_GEOMETRY)
    rng = np.random.default_rng(9)
    addr = np.full((3, 1024), tcache.SENTINEL, np.int32)
    addr[0] = rng.integers(0, 2048, 1024)
    addr = torch.from_numpy(addr).to(card)
    zero = torch.zeros_like(addr)
    carry = tcache.init_batch_carry(p, 3, device=card)
    kern = tkernels.mesi_segment(carry, addr, zero, zero, zero, params=p)
    plain = tkernels.mesi_segment(carry, addr, zero, zero, zero, params=p,
                                  backend="reference")
    for k, q, c in zip(kern, plain, carry):
        assert torch.equal(k, q)
        if k.ndim > 1:
            assert torch.equal(k[1:], c[1:])


def test_distribute_and_resilience_goldens_on_the_card(card, tmp_path):
    from repro_torch.core import distribute
    from repro_torch.core import resilience as R
    golden = pathlib.Path(__file__).resolve().parent / "golden"
    spec = tengine.SweepSpec(
        footprint_factors=(2,), policies=(tnuma.WeightedInterleave(1, 1),
                                          tnuma.ZNuma(1.0)),
        cpus=(CPUModel(kind="o3", mlp=8),))
    p, t = tcache.CacheParams(**GOLDEN_GEOMETRY), TimingConfig()
    tops.reset_launches()
    rows = distribute.run_sweep(spec, p, t, mesh=distribute.Mesh(n_shards=2),
                                stream_chunk=512)
    assert tops.LAUNCHES["mesi_segment"] == 2 * 8
    assert json.loads(json.dumps(rows)) == json.loads(
        (golden / "distribute.json").read_text())
    pol = R.CheckpointPolicy(tmp_path, every_segments=1, blocking=True)
    with pytest.raises(R.RunKilled):
        distribute.run_sweep(spec, p, t, stream_chunk=512, resume=pol,
                             fault_plan=R.FaultPlan((R.Fault(
                                 "crash", shard=0, segment=2),)))
    tops.reset_launches()
    rows = distribute.run_sweep(spec, p, t, stream_chunk=512, resume=pol)
    assert tops.LAUNCHES["mesi_segment"] == 8 - 2
    assert tops.LAUNCHES["mesi_segment_ref"] == 0
    assert json.loads(json.dumps(rows)) == json.loads(
        (golden / "resilience.json").read_text())


def paged_case(seed, b, h, kh, d, page, nblk, dtype, device):
    """Random pools and queries; sequence 0 empty, 1 ending mid-page, the
    rest random; every entry past a sequence's live blocks out of range."""
    rng = np.random.default_rng(seed)
    n_pages = b * nblk
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, kh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, d)).astype(np.float32)
    bt = rng.permutation(n_pages).reshape(b, nblk).astype(np.int32)
    cl = rng.integers(1, nblk * page + 1, (b,)).astype(np.int32)
    cl[0], cl[1] = 0, page + 1
    live = -(-cl // page)
    bt[np.arange(nblk)[None, :] >= live[:, None]] = n_pages + 7
    dt = getattr(torch, dtype)
    return [torch.from_numpy(x).to(device, dt) for x in (q, kp, vp)] + [
        torch.from_numpy(x).to(device) for x in (bt, cl)]


@pytest.mark.parametrize("d", [16, 64, 120, 128])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain_version(card, d, groups, dtype):
    args = paged_case(d + groups, 5, 2 * groups, 2, d, 16, 6, dtype, card)
    tops.reset_launches()
    kern = tops.paged_attention(*args)
    plain = tpa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  paged_attention=1, paged_attention_ref=1)
    assert kern.dtype == args[0].dtype and kern.shape == args[0].shape
    tol = 3e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(kern.float(), plain.float(), rtol=tol,
                               atol=tol)
    assert torch.all(kern[0] == 0)                  # empty context


def test_paged_attention_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, kp, vp, bt, cl = paged_case(0, 3, 4, 2, 16, 4, 4, "float32", card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.paged_attention(q.half(), kp, vp, bt, cl)
    with pytest.raises(ValueError, match="outside the pool"):
        tops.paged_attention(q, kp, vp, torch.full_like(bt, 10_000), cl)
    big = paged_case(0, 2, 2, 1, 272, 4, 2, "float32", card)
    with pytest.raises(ValueError, match="head_dim"):
        tops.paged_attention(*big)


def test_serve_runs_on_the_card(card):
    cfg = get_smoke("h2o-danube-3-4b")
    tops.reset_launches()
    r = tserve.run(cfg, requests=3, prefill=20, decode=3, page_size=4,
                   hbm_pages=5)
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  paged_attention=3)
    assert r["logits_finite"] and r["kv_stats"]["demotions"] > 0
    q, kp, vp, bt, cl = r["last_attn_inputs"]
    assert q.is_cuda and kp.is_cuda and bt.dtype == torch.int32
    torch.testing.assert_close(r["attn_out"][-1],
                               tpa.paged_attention_ref(q, kp, vp, bt, cl),
                               rtol=3e-5, atol=3e-5)
    on_cpu = tserve.run(cfg, requests=3, prefill=20, decode=3, page_size=4,
                        hbm_pages=5, device="cpu")
    assert r["kv_stats"] == on_cpu["kv_stats"]
    assert r["tier_histogram"] == on_cpu["tier_histogram"]


@pytest.mark.parametrize("n_sets,n_ways,n,span", [
    (16, 2, 256, 4), (64, 4, 1024, 4), (128, 8, 555, 4), (32, 1, 333, 4),
    (2048, 16, 5000, 3), (4, 32, 777, 2)])
def test_cache_sim_kernel_matches_plain_version(card, n_sets, n_ways, n,
                                                span):
    rng = np.random.default_rng(n)
    addr = torch.from_numpy(rng.integers(0, n_sets * n_ways * span, n)
                            .astype(np.int32)).to(card)
    tops.reset_launches()
    kern = tops.cache_sim(addr, n_sets=n_sets, n_ways=n_ways)
    plain = tops.cache_sim_ref(addr, n_sets=n_sets, n_ways=n_ways)
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                 cache_sim=1, cache_sim_ref=1)
    for k, p in zip(kern, plain):
        assert k.is_cuda and torch.equal(k, p)
    bad = addr.clone()
    bad[n // 2] = -1
    with pytest.raises(ValueError, match="negative"):
        tops.cache_sim(bad, n_sets=n_sets, n_ways=n_ways)


@pytest.mark.parametrize("shape", [(8, 128), (16, 1000), (64, 4097)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2.5, 0.1])
def test_stream_triad_kernel_matches_plain_version(card, shape, dtype, s):
    rng = np.random.default_rng(shape[1])
    b, c = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(card, getattr(torch, dtype)) for _ in range(2))
    tops.reset_launches()
    kern = tops.stream_triad(b, c, s)
    plain = tops.stream_triad_ref(b, c, s)
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                 stream_triad=1, stream_triad_ref=1)
    assert kern.dtype == b.dtype and torch.equal(kern, plain)
    # a misaligned view takes the kernel's scalar path
    off = ttriad.stream_triad(b.view(-1)[1:1 + 8 * 100].view(8, 100),
                              c.view(-1)[3:3 + 8 * 100].view(8, 100), s)
    assert torch.equal(off, ttriad.stream_triad_ref(
        b.view(-1)[1:801].view(8, 100), c.view(-1)[3:803].view(8, 100), s))


@pytest.mark.parametrize("b,h,sq,sk,d,win,causal,dtype", [
    (2, 4, 128, 128, 64, None, True, "float32"),
    (1, 2, 128, 256, 64, None, True, "float32"),
    (2, 4, 256, 256, 64, 64, True, "float32"),
    (1, 2, 128, 128, 128, None, True, "bfloat16"),
    (1, 8, 384, 384, 32, 128, True, "float32"),
    (1, 2, 256, 256, 120, None, True, "float32"),
    (1, 2, 256, 128, 120, None, True, "bfloat16"),
    (1, 2, 128, 256, 64, None, False, "float32"),
    (1, 2, 256, 256, 64, 20, True, "float32"),
    (1, 2, 128, 128, 32, 1000, True, "float32"),
    (1, 1, 24, 24, 16, None, True, "float32"),
])
def test_flash_attention_kernel_matches_plain_version(card, b, h, sq, sk, d,
                                                      win, causal, dtype):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, getattr(torch, dtype))
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    tops.reset_launches()
    kern = tops.flash_attention(q, k, v, causal=causal, window=win)
    plain = tfa.flash_attention_ref(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                 flash_attention=1, flash_attention_ref=1)
    assert kern.dtype == q.dtype and kern.shape == q.shape
    tol = 3e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(kern.float(), plain.float(), rtol=tol,
                               atol=tol)
    if sq > sk and causal:
        assert torch.all(kern[:, :, :sq - sk] == 0)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros((1, 2, 128, 16), device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="share a dtype"):
        tops.flash_attention(q, q.bfloat16(), q)
    big = torch.zeros((1, 1, 128, 136), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_attention(big, big, big)


@pytest.mark.parametrize("case", ["aligned", "misaligned", "ragged", "bf16"])
def test_stream_triad_sized_grid_matches_plain_version(card, case):
    """The sized-grid launch bitwise: aligned f32; views 1 and 3 elements
    off 16 bytes (the scalar path); n = 8008, no multiple of a 4-vector
    chunk's block (the tail); bf16."""
    rng = np.random.default_rng(len(case))
    shape, dtype = {"aligned": ((64, 4096), torch.float32),
                    "misaligned": ((64, 4096), torch.float32),
                    "ragged": ((8, 1001), torch.float32),
                    "bf16": ((64, 1000), torch.bfloat16)}[case]
    b, c = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(card, dtype) for _ in range(2))
    if case == "misaligned":
        b = b.view(-1)[1:1 + 8 * 1000].view(8, 1000)
        c = c.view(-1)[3:3 + 8 * 1000].view(8, 1000)
    for s in (2.5, 0.1):
        got = ttriad._launch(b, c, s)
        assert got.dtype == dtype and torch.equal(
            got, ttriad.stream_triad_ref(b, c, s))


@pytest.mark.parametrize("b,h,sq,sk,d,win,causal", [
    (1, 1, 24, 24, 16, None, True),       # a sequence shorter than a tile
    (1, 2, 256, 128, 32, None, True),     # Sq > Sk: rows with no key
    (1, 2, 128, 256, 64, None, True),     # Sq < Sk
    (1, 2, 256, 256, 120, 20, True),      # a window shorter than a tile
    (1, 2, 256, 256, 128, 1000, True),    # one longer than the sequence
    (1, 2, 128, 256, 120, None, False),   # non-causal
    (1, 2, 128, 512, 120, 200, True),     # a window over a longer Sk
    (2, 4, 384, 384, 64, 128, True),
    (1, 1, 24, 24, 128, None, False),
])
def test_flash_attention_tensor_core_kernel_matches_plain_version(
        card, b, h, sq, sk, d, win, causal):
    """bf16 with D % 8 == 0 runs the wgmma kernel (its own count says so),
    within the JAX test's bf16 tolerance of the plain version."""
    rng = np.random.default_rng(7 * sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, torch.bfloat16)
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    tops.reset_launches()
    tfa.reset_variant_launches()
    kern = tops.flash_attention(q, k, v, causal=causal, window=win)
    plain = tfa.flash_attention_ref(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES == {"tensor_cores": 1, "cuda_cores": 0}
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                 flash_attention=1, flash_attention_ref=1)
    assert kern.dtype == q.dtype and kern.shape == q.shape
    torch.testing.assert_close(kern.float(), plain.float(), rtol=3e-2,
                               atol=3e-2)
    if sq > sk and causal:
        assert torch.all(kern[:, :, :sq - sk] == 0)


def test_flash_attention_tensor_core_kernel_meets_the_main_path_limits(card):
    """(1, 4, 1024, 120) bf16, causal, danube's window: within rtol = atol
    = 5e-3 of the plain version and RMS(err) <= 1e-3 RMS(ref), the limits
    chip_smoke.py holds the danube prefill to (a bf16 p would miss them)."""
    rng = np.random.default_rng(1024)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 1024, 120))
                                .astype(np.float32)).to(card, torch.bfloat16)
               for _ in range(3))
    tfa.reset_variant_launches()
    got = tops.flash_attention(q, k, v, causal=True, window=4096).float()
    ref = tfa.flash_attention_ref(q, k, v, causal=True, window=4096).float()
    assert tfa.VARIANT_LAUNCHES["tensor_cores"] == 1
    diff = (got - ref).abs()
    assert bool((diff <= 5e-3 * (1 + ref.abs())).all())
    assert float(diff.square().mean().sqrt()) <= 1e-3 * float(
        ref.square().mean().sqrt())


@pytest.mark.parametrize("dtype,d,want", [
    ("bfloat16", 64, "tensor_cores"), ("bfloat16", 12, "cuda_cores"),
    ("float32", 64, "cuda_cores")])
def test_flash_attention_variant_on_the_card(card, dtype, d, want):
    """The wrapper launches the variant that (dtype, D) picks, and the
    tensor-core kernel refuses what it does not take."""
    q = torch.randn((1, 2, 128, d), device=card).to(getattr(torch, dtype))
    tfa.reset_variant_launches()
    got = tops.flash_attention(q, q, q)
    torch.testing.assert_close(
        got.float(), tfa.flash_attention_ref(q, q, q).float(),
        rtol=3e-2 if dtype == "bfloat16" else 3e-5,
        atol=3e-2 if dtype == "bfloat16" else 3e-5)
    assert tfa.VARIANT_LAUNCHES == dict(
        dict.fromkeys(tfa.VARIANT_LAUNCHES, 0), **{want: 1})
    if want == "cuda_cores" and dtype == "bfloat16":
        out = torch.empty_like(q)
        rc = tfa._library().flash_attention_tc(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 2, 128,
            128, d, 1, 0, 0, d ** -0.5, card.index or 0,
            torch.cuda.current_stream(card).cuda_stream)
        assert rc == 1  # cudaErrorInvalidValue



# ---------------------------------------------------------------------------
# K6 split into set chains, K4 split over the context
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_sets", [1, 2, 2048, 8192])
@pytest.mark.parametrize("n_ways", [1, 16, 32])
def test_cache_sim_chains_match_plain_version(card, n_sets, n_ways):
    """One chain (1 set), few chains (2), one set per chain (2048) and
    several sets per chain (8192 > 2**MAX_CHAIN_BITS), bitwise on hits,
    tags and clocks; then an empty trace and one crowded into one set."""
    rng = np.random.default_rng(n_sets + n_ways)
    n = 6000 if n_sets < 2048 else 40_000
    traces = [rng.integers(0, n_sets * n_ways * 3, n),
              np.zeros(0, np.int64),
              n_sets * rng.integers(0, 3 * n_ways, 3000) + n_sets // 2]
    plan = tkernels.cache_sim_plan(n_sets, n_ways, card)
    assert plan["bits"] == min(n_sets.bit_length() - 1,
                               tkernels.MAX_CHAIN_BITS)
    assert plan["in_regs"] == (n_sets <= 1 << tkernels.MAX_CHAIN_BITS)
    for addr in traces:
        addr = torch.from_numpy(addr.astype(np.int32)).to(card)
        tops.reset_launches()
        kern = tops.cache_sim(addr, n_sets=n_sets, n_ways=n_ways)
        assert tops.LAUNCHES["cache_sim"] == 1
        plain = tops.cache_sim_ref(addr, n_sets=n_sets, n_ways=n_ways)
        for k, p in zip(kern, plain):
            assert k.is_cuda and torch.equal(k, p)


@pytest.mark.parametrize("n_sets,warps,in_smem", [
    (1 << 22, 1, 1),        # 1024 sets per chain: 128 KiB, one warp a block
    (1 << 23, 4, 0)])       # 2048 sets per chain: too big, the outputs
def test_cache_sim_chain_layouts(card, n_sets, warps, in_smem):
    """Chains whose sets fill a block's shared memory alone, and chains
    whose sets live in the output tensors, bitwise."""
    plan = tkernels.cache_sim_plan(n_sets, 16, card)
    assert (plan["warps_per_block"], plan["in_regs"], plan["in_smem"]) == (
        warps, 0, in_smem)
    rng = np.random.default_rng(n_sets)
    addr = torch.from_numpy(rng.integers(0, 2**31 - 1, 100_000)
                            .astype(np.int32)).to(card)
    # and 500 accesses crowded into one set (97 lines over its 16 ways)
    addr[:500] = 12345 + n_sets * (torch.arange(500, device=card,
                                                dtype=torch.int32) % 97)
    kern = tops.cache_sim(addr, n_sets=n_sets, n_ways=16)
    plain = tops.cache_sim_ref(addr, n_sets=n_sets, n_ways=16)
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)


def long_paged_case(seed, ctxs, h, kh, d, nblk, dtype, device, page=16):
    """One sequence per context in `ctxs`; pools of nblk pages per
    sequence; entries past the live blocks out of range."""
    rng = np.random.default_rng(seed)
    b = len(ctxs)
    n_pages = b * nblk
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, kh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, d)).astype(np.float32)
    bt = rng.permutation(n_pages).reshape(b, nblk).astype(np.int32)
    cl = np.asarray(ctxs, np.int32)
    bt[np.arange(nblk)[None, :] >= (-(-cl // page))[:, None]] = n_pages + 3
    dt = getattr(torch, dtype)
    return [torch.from_numpy(x).to(device, dt) for x in (q, kp, vp)] + [
        torch.from_numpy(x).to(device) for x in (bt, cl)]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("d", [16, 120, 256])
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_split_matches_plain_version(card, split, d, groups,
                                                     dtype):
    """Contexts 0, 1, L - 1, L, L + 1 and the capacity (4096 where split),
    L the partition length; one partition (capacity 256) or several; two
    calls give the same bits."""
    kh, nblk = 2, (256 if split else 16)
    kv = torch.empty((1, 16, kh, d), dtype=getattr(torch, dtype),
                     device=card)
    plan = tpa.launch_plan(torch.empty((6, groups * kh, d), dtype=kv.dtype,
                                       device=card), kv, kv,
                           torch.empty((6, nblk), dtype=torch.int32))
    part_len = plan["part_len"]
    assert (plan["parts"] > 1) == split and plan["resident"] >= 1
    ctxs = [0, 1, part_len - 1, part_len, part_len + 1, nblk * 16]
    args = long_paged_case(d * groups, [min(c, nblk * 16) for c in ctxs],
                           groups * kh, kh, d, nblk, dtype, card)
    tops.reset_launches()
    kern = tops.paged_attention(*args)
    again = tops.paged_attention(*args)
    assert tops.LAUNCHES["paged_attention"] == 2
    plain = tpa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(kern.float(), plain.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(kern, again)
    assert torch.all(kern[0] == 0)                  # empty context


@pytest.mark.parametrize("case", ["d20_bf16", "misaligned_f32"])
def test_paged_attention_plain_load_path(card, case):
    """Rows that are no multiple of 16 bytes, and pools that are not
    16-byte aligned, take the kernel's plain loads."""
    d = 20 if case == "d20_bf16" else 64
    dtype = "bfloat16" if case == "d20_bf16" else "float32"
    q, kp, vp, bt, cl = long_paged_case(7, [0, 33, 300, 512], 8, 2, d, 32,
                                        dtype, card)
    if case == "misaligned_f32":
        kp, vp = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:]
                  .view(x.shape) for x in (kp, vp))
        assert kp.data_ptr() % 16 != 0
    kern = tops.paged_attention(q, kp, vp, bt, cl)
    plain = tpa.paged_attention_ref(q, kp, vp, bt, cl)
    tol = 3e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(kern.float(), plain.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch,accum", [("h2o-danube-3-4b", 1),
                                        ("h2o-danube-3-4b", 2),
                                        ("qwen3-moe-235b-a22b", 1)])
def test_training_runs_on_the_card(card, tmp_path, arch, accum):
    """`launch.train.run` at smoke size in float32, on the card and on the
    CPU from the same weights; no kernel launches on this path."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    p0 = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(steps=3, batch=4, seq=16, accum_steps=accum, log_every=0)
    tops.reset_launches()
    on_card = ttrain.run(cfg, device=card, ckpt_dir=str(tmp_path / "c"),
                         params=ttree.tree_map(lambda x: x.to(card), p0),
                         **kw)
    assert not any(tops.LAUNCHES.values())
    on_cpu = ttrain.run(cfg, device="cpu", ckpt_dir=str(tmp_path / "h"),
                        params=ttree.tree_map(torch.clone, p0), **kw)
    losses = [[e["loss"] for e in r["log"] if e["event"] == "step"]
              for r in (on_card, on_cpu)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(ttree.leaves(on_card["state"]),
                    ttree.leaves(on_cpu["state"])):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_moe_ffn_on_the_card_matches_cpu(card):
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"),
                              dtype="float32")
    params = tmoe.moe_init(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((2, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    y, aux = tmoe.moe_ffn(ttree.tree_map(lambda t: t.to(card), params),
                          x.to(card), cfg)
    want, want_aux = tmoe.moe_ffn(params, x, cfg)
    torch.testing.assert_close(y.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# the rwkv, rec and MLA kinds: K4 at their serve shapes, the models on the
# card against the CPU
# ---------------------------------------------------------------------------
#: (query heads, kv heads, head_dim) of K4's serve launches for rwkv6-1.6b,
#: recurrentgemma-9b (16 groups of D = 256: the wrapper's limits) and
#: deepseek-v3-671b
NEW_K4_SHAPES = {"rwkv6-1.6b": (32, 32, 64), "recurrentgemma-9b": (16, 1, 256),
                 "deepseek-v3-671b": (128, 128, 192)}


@pytest.mark.parametrize("arch", list(NEW_K4_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_at_the_new_serve_shapes(card, arch, dtype):
    """K4 at the serve loop's shape for each new kind (8 sequences, 6
    blocks of 16; an empty, a partial and random contexts)."""
    h, kh, d = NEW_K4_SHAPES[arch]
    assert (h, kh, d) == (get_config(arch).n_heads, get_config(arch)
                          .n_kv_heads, get_config(arch).head_dim)
    args = paged_case(d + h, 8, h, kh, d, 16, 6, dtype, card)
    tops.reset_launches()
    kern = tops.paged_attention(*args)
    assert tops.LAUNCHES["paged_attention"] == 1
    plain = tpa.paged_attention_ref(*args)
    tol = 3e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(kern.float(), plain.float(), rtol=tol,
                               atol=tol)
    assert torch.all(kern[0] == 0)                  # empty context


def _grads_close(a, b):
    """Gradients card against CPU: rtol 1e-4, atol 1e-4 x max(1, max|b|)
    (rwkv's u gradient reaches ~100 where the per-head norm divides by
    sqrt(eps))."""
    for x, y in zip(ttree.leaves(a), ttree.leaves(b)):
        torch.testing.assert_close(
            x.cpu(), y, rtol=1e-4,
            atol=1e-4 * max(1.0, float(y.abs().max())))


@pytest.mark.parametrize("arch", list(NEW_K4_SHAPES))
def test_new_kinds_on_the_card_match_cpu(card, arch):
    """Smoke size, float32, the same weights on the card and on the CPU:
    prefill logits and caches, three decode steps, the loss and its
    gradients (rtol = atol = 1e-4: cuBLAS and the CPU sum in different
    orders); rwkv's 128-token loss takes the chunked WKV."""
    from repro_torch.models import model as tmodel
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    p_cpu = ttf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_card = ttree.tree_map(lambda x: x.to(card), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    outs = {}
    for where, p in (("card", p_card), ("cpu", p_cpu)):
        logits, caches = ttf.forward_prefill(p, cfg, toks.to(p["final_norm"]
                                                             ["scale"].device))
        caches = ttf.pad_cache(caches, cfg, 24)
        steps = [logits]
        for ctx in range(20, 23):
            logits, caches = ttf.decode_step(p, cfg, toks[:, ctx - 20].to(
                logits.device), caches, ctx)
            steps.append(logits)
        outs[where] = (steps, caches)
    for a, b in zip(outs["card"][0], outs["cpu"][0]):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    _grads_close(outs["card"][1], outs["cpu"][1])
    seq = 128 if arch == "rwkv6-1.6b" else 24
    b = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq),
                                 generator=torch.Generator().manual_seed(5),
                                 dtype=torch.int32)}
    tops.reset_launches()
    l_card, g_card = tmodel.value_and_grad(
        p_card, cfg, {k: v.to(card) for k, v in b.items()})
    assert not any(tops.LAUNCHES.values())
    l_cpu, g_cpu = tmodel.value_and_grad(p_cpu, cfg, b)
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)
    _grads_close(g_card, g_cpu)


@pytest.mark.parametrize("arch", list(NEW_K4_SHAPES))
def test_serve_runs_the_new_kinds_on_the_card(card, arch):
    """serve.run at smoke size: one K4 launch per decode step over a pool
    that only the decode steps' zero rows fill; KVStats as on the CPU."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    p_cpu = ttf.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    kw = dict(requests=3, prefill=20, decode=3, page_size=4, hbm_pages=5)
    tops.reset_launches()
    r = tserve.run(cfg, params=ttree.tree_map(lambda x: x.to(card), p_cpu),
                   **kw)
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  paged_attention=3)
    on_cpu = tserve.run(cfg, device="cpu", params=p_cpu, **kw)
    assert r["logits_finite"] and r["kv_stats"] == on_cpu["kv_stats"]
    assert r["tokens"] == on_cpu["tokens"]
    assert not r["last_attn_inputs"][1].any()


#: smoke configs whose decode step serve.run replays from a CUDA graph:
#: a rolled 16-token window, M-RoPE, qk-norm
GRAPHED = ("h2o-danube-3-4b", "qwen2-vl-2b", "stablelm-12b")


def _twin(caches):
    return [[{b: {k: v.clone() for k, v in e.items()}
              for b, e in period.items()} for period in seg]
            for seg in caches]


@pytest.mark.parametrize("arch", GRAPHED)
def test_serve_replays_decode_step_from_a_cuda_graph(card, monkeypatch,
                                                     arch):
    """serve.run at smoke size: each sequence's first step eager, the
    second captured, every later one replayed.  Each `decode_step` call
    gives, bitwise, the logits and the caches of an eager `decode_step`
    (int context length) on copies of its inputs, as a tensor of its own;
    the tokens, KVStats and K4 outputs are those of the serve with the
    graph path off."""
    cfg = get_smoke(arch)
    kw = dict(requests=3, prefill=20, decode=4, page_size=4, hbm_pages=5)
    params = ttf.init_params(cfg, torch.Generator(device=card).manual_seed(3),
                             card)
    saved = ttf.decode_step
    calls = []

    def checked(p, c, token, caches, ctx_len):
        twin = _twin(caches)
        want, twin = saved(p, c, token, twin, ctx_len)
        got, caches = saved(p, c, token, caches, ctx_len)
        same = all(torch.equal(x[b][k], y[b][k])
                   for sa, sb in zip(caches, twin) for x, y in zip(sa, sb)
                   for b in x for k in x[b])
        calls.append((torch.equal(got, want), same, got))
        return got, caches

    monkeypatch.setattr(ttf, "decode_step", checked)
    tops.reset_launches()
    r = tserve.run(cfg, device=card, params=params, **kw)
    assert tops.LAUNCHES["paged_attention"] == 4
    assert r["decode_graph"] == {"captured": 3, "replayed": 9, "eager": 3}
    assert len(calls) == 12
    assert all(logits_equal for logits_equal, _, _ in calls)
    assert all(caches_equal for _, caches_equal, _ in calls)
    assert len({got.data_ptr() for _, _, got in calls}) == 12
    monkeypatch.setattr(ttf, "decode_step", saved)
    monkeypatch.setattr(ttf, "graphable", lambda cfg, device: False)
    eager = tserve.run(cfg, device=card, params=params, **kw)
    assert eager["decode_graph"] == {"captured": 0, "replayed": 0,
                                     "eager": 12}
    assert r["tokens"] == eager["tokens"]
    assert r["kv_stats"] == eager["kv_stats"]
    assert all(torch.equal(a, b)
               for a, b in zip(r["attn_out"], eager["attn_out"]))


@pytest.mark.parametrize("arch", list(NEW_K4_SHAPES))
def test_serve_keeps_the_steps_a_graph_does_not_take_eager(card, arch):
    """rwkv, rec and MLA blocks: serve.run captures nothing and runs
    every step eagerly."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    r = tserve.run(cfg, device=card, requests=3, prefill=20, decode=3,
                   page_size=4, hbm_pages=5)
    assert r["decode_graph"] == {"captured": 0, "replayed": 0, "eager": 9}
    assert r["logits_finite"]


def test_serve_capture_under_the_profiler(card):
    """The graphed serve under torch.profiler (CPU and CUDA activities):
    one ``serve.capture`` span per sequence, tokens and KVStats as with
    the profiler off."""
    cfg = get_smoke("h2o-danube-3-4b")
    kw = dict(requests=3, prefill=20, decode=4, page_size=4, hbm_pages=5)
    params = ttf.init_params(cfg, torch.Generator(device=card).manual_seed(4),
                             card)
    off = tserve.run(cfg, device=card, params=params, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        on = tserve.run(cfg, device=card, params=params, **kw)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert sorted(n for n in names if n.startswith(
        "repro_torch.serve.capture")) == [
        f"repro_torch.serve.capture#{sid}" for sid in range(3)]
    assert on["decode_graph"] == off["decode_graph"] == {
        "captured": 3, "replayed": 9, "eager": 3}
    assert on["tokens"] == off["tokens"]
    assert on["kv_stats"] == off["kv_stats"]


def test_codec_on_the_card_matches_cpu(card):
    """The CXL.mem flit codec's headers and decoded fields, bitwise."""
    from repro_torch.core import packet
    gen = torch.Generator().manual_seed(12)
    n = 4099
    addr = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                         dtype=torch.int32)
    wr = torch.rand(n, generator=gen) < 0.5
    tags = torch.randint(0, 2**17, (n,), generator=gen, dtype=torch.int32)
    nxm = torch.rand(n, generator=gen) < 0.2
    outs = []
    for where in (card, torch.device("cpu")):
        m2s = packet.rc_packetize(addr.to(where), wr.to(where),
                                  tags=tags.to(where), ld_id=5)
        s2m = packet.ep_respond(m2s["headers"], nxm=nxm.to(where))
        fields = {**packet.ep_depacketize(m2s["headers"]),
                  **{"s2m_" + k: v for k, v in
                     packet.rc_complete(s2m["headers"]).items()}}
        outs.append({"m2s": m2s["headers"], "s2m": s2m["headers"],
                     **fields})
    for k, v in outs[1].items():
        assert torch.equal(outs[0][k].cpu(), v), k


@pytest.mark.parametrize("arch,kind", [("h2o-danube-3-4b", "train"),
                                       ("rwkv6-1.6b", "prefill"),
                                       ("deepseek-v3-671b", "decode")])
def test_dryrun_on_fake_cuda_counts_a_card_runs_flops(card, arch, kind):
    """The dry run on fake CUDA tensors at smoke size counts the FLOPs of
    the same step run on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    from repro_torch.models import model as tmodel
    from repro_torch.optim import adamw
    full, cfg = get_config(arch), get_smoke(arch)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full, f.name)}
    cell = tmodel.ShapeCell(f"smoke_{kind}", 16, 2, kind)
    res = dryrun.run_cell(arch, cell, overrides=over)
    assert res.status == "ok" and res.device == "cuda", res.note
    params = ttf.init_params(cfg, torch.Generator(card).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                           device=card)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            tmodel.make_train_step(cfg, adamw.AdamWConfig())(
                params, adamw.init(params), {"tokens": tokens})
        elif kind == "prefill":
            tmodel.prefill_step(params, cfg, {"tokens": tokens})
        else:
            tmodel.serve_step(params, cfg, tokens[:, 0],
                              ttf.init_cache(cfg, 2, 16), 15)
    assert res.flops == counter.get_total_flops() > 0


def test_analysis_audit_on_the_card_is_clean(card):
    """The graph audit on the card: the kernel entry points are traced,
    and the MESI and epoch kernels triangulate bitwise with the reference
    at 2, 3 and 4 targets."""
    from repro_torch.analysis import contracts
    names = [n for n, _, _ in contracts.entry_points(card)]
    assert {"run_batch_segment[cuda]", "run_dynamic[cuda]"} <= set(names)
    tops.reset_launches()
    findings = contracts.run_audit(card)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert tops.LAUNCHES["mesi_segment"] == 10
    assert tops.LAUNCHES["mesi_dyn_segment"] == 7


def test_stat_layout_catches_a_drifted_kernel(card, monkeypatch):
    """A kernel whose counters come out in another order (its C copy of
    the layout drifted) fails RA404's triangulation on the card."""
    from repro_torch.analysis import contracts
    real = tkernels._launch

    def drifted(*args, **kwargs):
        l1p, l2p, stats, t = real(*args, **kwargs)
        return l1p, l2p, stats.flip(-1).contiguous(), t

    monkeypatch.setattr(tkernels, "_launch", drifted)
    findings = contracts.check_stat_layout(card)
    assert {f.code for f in findings} == {"RA404"}
    assert any("run_traces[cuda] disagrees" in f.message for f in findings)
