"""The per-layer metrics' byte and FLOP counts against hand counts and
against the program's own arithmetic they were copied from."""
import torch

from harness.core import BENCH, Cell, load_module, read_json
from harness.trace import Summary

PEAKS = read_json(BENCH / "harness" / "peaks.json")


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "test_metric_")


def test_k1_bytes_by_hand():
    k1 = metric("k1_roofline_pct")
    # Table-I carry of 16 rows: L1 128 x 8 x 3, L2 2048 x 16 x 5, 12
    # counters and the clock, int32
    carry = 16 * 4 * (128 * 8 * 3 + 2048 * 16 * 5 + 12 + 1)
    call = {"rows": 16, "fixed_bytes": 2 * carry, "field_bytes": 16}
    assert k1.bound_bytes([call], 20_971_500) == 20_971_500 * 16 + 2 * carry
    assert carry == 10_683_200
    from repro_torch.core.cache import CacheParams
    sweep = load_module(BENCH / "generators" / "sweep.py", "test_generator_")
    p = CacheParams(l1_bytes=65536, l1_ways=8, l2_bytes=2 << 20, l2_ways=16)
    trace = [torch.zeros((16, 8), dtype=torch.int32)] * 4
    assert sweep.launch_bytes("k1", 0, trace, {"params": p}) == call
    s = Summary(1e4, 5e3, [("mesi", 1e4, "bench.k1")], [])
    ctx = {"summary": s, "peaks": PEAKS,
           "counters": {"k1_calls": [call], "traced_sweeps": 1,
                        "accesses_per_sweep": 20_971_500}}
    want = 100 * (20_971_500 * 16 + 2 * carry) / 3.35e12 / 1e-2
    assert abs(k1.read(ctx) - want) < 1e-9


def test_k3_bytes_by_hand():
    """The recorder's bytes of one K3 launch against a hand count: sweep
    A's 9 rows at Table-I, 512 slots of 2048, 4096 pages, two targets."""
    from repro_torch.core import tiering_dyn
    from repro_torch.core.cache import CacheParams
    sweep = load_module(BENCH / "generators" / "sweep.py", "test_generator_")
    p = CacheParams(l1_bytes=65536, l1_ways=8, l2_bytes=2 << 20, l2_ways=16)
    b, e, slot, n_p = 9, 512, 2048, 4096
    carry = tiering_dyn.init_dyn_carry(p, torch.ones((b, n_p),
                                                     dtype=torch.int32))
    trace = [torch.zeros((b, e, slot), dtype=torch.int32)] * 4
    rows = [torch.zeros(b, dtype=torch.int32)] * 8
    ptl = torch.zeros((b, n_p, 2), dtype=torch.int32)
    samp = [torch.zeros(b, dtype=torch.int32)] * 3
    call = sweep.launch_bytes("k3", 1, (carry, *trace, *rows, ptl, *samp),
                              {"params": p})
    # L1 128 x 8 x 3, L2 2048 x 16 x 5, 12 counters, clock, page map and
    # counts of 4096, migration totals 2 + 2, epoch index; int32 per row
    carry_b = 4 * b * (128 * 8 * 3 + 2048 * 16 * 5 + 12 + 1 + 2 * n_p + 4
                       + 1)
    inputs = 4 * b * (8 + 3 + n_p * 2)
    outputs = 4 * b * e * (4 + 12 + 1)
    assert call == {"rows": b, "field_bytes": 16,
                    "fixed_bytes": 2 * carry_b + inputs + outputs}
    k3 = metric("k3_roofline_pct")
    s = Summary(1e5, 5e4, [("mesi_dyn", 4e4, "bench.k3")], [])
    ctx = {"summary": s, "peaks": PEAKS,
           "counters": {"k3_calls": [call], "traced_sweeps": 1,
                        "accesses_per_sweep": 6_756_366}}
    want = 100 * (6_756_366 * 16 + call["fixed_bytes"]) / 3.35e12 / 4e-2
    assert abs(k3.read(ctx) - want) < 1e-9


def test_k4_bytes_match_the_programs_bound_bytes():
    from repro_torch.kernels.paged_attention import bound_bytes
    k4 = metric("k4_roofline_pct")
    q = torch.zeros(8, 32, 120)
    pages = torch.zeros(568, 16, 8, 120)
    bt = torch.zeros(8, 70, dtype=torch.int32)
    ctx = torch.tensor([1024, 1030, 1, 0, 1087, 16, 17, 2000],
                       dtype=torch.int32)
    call = {"q": (8, 32, 120), "q_bytes": 4, "pages": (568, 16, 8, 120),
            "kv_bytes": 4, "blocks": 70, "ctx": ctx.tolist()}
    assert k4.bound_bytes(call) == bound_bytes(q, pages, bt, ctx)
    # by hand at one sequence of 17 positions over pages of 16
    one = dict(call, q=(1, 32, 120), ctx=[17])
    assert k4.bound_bytes(one) == (2 * 32 * 120 * 4 + 17 * 8 * 2 * 120 * 4
                                   + 4 * (2 + 1))


def test_decode_flops_match_the_dry_runs_model_flops():
    from repro_torch.models.model import ShapeCell
    from repro_torch.roofline.analysis import model_flops
    program_config = load_module(BENCH / "generators" / "serve.py",
                                 "test_generator_").program_config
    mfu = metric("decode_mfu_pct")
    m = Cell("h2o-danube-3-4b.serve-spill").config["model"]
    cfg = program_config(m)
    for ctx in (1, 1025, 4096, 5000):
        want = model_flops(cfg, ShapeCell("decode", ctx, 1, "decode"))
        assert abs(mfu.token_flops(m, ctx) - want) <= 1e-6 * want
    assert mfu.n_params(m) == cfg.n_params() == 3_961_651_200
    small = dict(m, n_layers=1, d_model=4, d_ff=2, vocab_size=10, n_heads=2,
                 n_kv_heads=1, head_dim=2, window=3)
    # embed 40 + head 40 + attn 4 * (4 + 4) + 4 * 4 + mlp 3 * 4 * 2
    assert mfu.n_params(small) == 40 + 40 + 32 + 16 + 24
    assert mfu.token_flops(small, 5) == 2 * 152 + 4 * 2 * 2 * 3


def test_idle_share_and_engine_time():
    s = Summary(100.0, 25.0, [("a", 10.0, "bench.k1"), ("b", 15.0, None),
                              ("c", 20.0, "bench.k3")], [])
    ctx = {"summary": s, "counters": {"traced_sweeps": 5}}
    assert metric("device_idle_pct.sweep").read(ctx) == 75.0   # of 100
    assert metric("engine_device_ms.sweep").read(ctx) == 15.0 / 5 / 1e3


def test_readers_stay_silent_without_a_trace():
    ctx = {"summary": None, "peaks": PEAKS,
           "counters": {"calls": 0, "k1_calls": [], "k3_calls": [],
                        "k4_calls": []}}
    for name in ("k1_roofline_pct", "k3_roofline_pct", "k4_roofline_pct",
                 "device_idle_pct.sweep", "device_idle_pct.serve",
                 "engine_device_ms.sweep", "decode_mfu_pct",
                 "prefill_ms_per_request.serve"):
        assert metric(name).read(ctx) is None, name

