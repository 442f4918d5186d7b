"""The CUDA MESI kernel on the card: against its plain version, bitwise.

Every test here needs a CUDA device (the kernel has no CPU mode) and skips
without one.  The file imports no JAX, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig
from repro_torch.kernels import cache_sim as tkernels

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
    tkernels.reset_launches()
    kern = tkernels.mesi_cache_sim(*trace, params=p)
    plain = tkernels.mesi_cache_sim(*trace, params=p, backend="reference")
    assert tkernels.LAUNCHES == {"mesi_segment": 1, "mesi_segment_ref": 1}
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
    tkernels.reset_launches()
    on_card = tengine.run_sweep(spec, p, TimingConfig())
    assert tkernels.LAUNCHES == {"mesi_segment": 1, "mesi_segment_ref": 0}
    assert on_card == tengine.run_sweep(spec, p, TimingConfig(), device="cpu")
