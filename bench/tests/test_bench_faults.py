"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (the look for a card skipped: the CPU
runs the kernels' plain versions) with one fault planted in the program:
a step that returns its state unchanged, half of the batch left out and the
mean of the rest put in its place, an answer altered where it is made.
The cells run on one card, so no exchange between cards can be left out.
"""
import json

import pytest
import torch

import run as bench_run
from bench_cells import small_serve_cell, small_sweep_cell, small_tiering_cell

CPU = torch.device("cpu")


def run_line(cell):
    line, _, rc = bench_run.run_cell(cell, 2**31 + 21, 0.0, False, CPU)
    assert rc == 0
    return json.loads(line)


# ---- the sweep cell: K1 (ops.mesi_cache_sim) --------------------------------
def _k1_unchanged(real):
    from repro_torch.core.cache import init_batch_carry, unpack_state

    def k1(addr, is_write, core, tier, *, params, **kw):
        l1p, l2p, stats, _ = init_batch_carry(params, addr.shape[0])
        return stats, unpack_state(l1p, l2p)
    return k1


def _k1_half_batch(real):
    def k1(addr, is_write, core, tier, *, params, **kw):
        h = max(addr.shape[0] // 2, 1)
        stats, st = real(addr[:h], is_write[:h], core[:h], tier[:h],
                         params=params, **kw)
        mean = stats.float().mean(dim=0, keepdim=True).round().to(stats.dtype)
        return torch.cat([stats, mean.expand(addr.shape[0] - h, -1)]), st
    return k1


def _k1_altered(real):
    def k1(addr, is_write, core, tier, *, params, **kw):
        stats, st = real(addr, is_write, core, tier, params=params, **kw)
        stats = stats.clone()
        stats[-1, 3] += 1                 # one more L2 miss in the last row
        return stats, st
    return k1


@pytest.mark.parametrize("fault", [_k1_unchanged, _k1_half_batch,
                                   _k1_altered])
def test_sweep_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "mesi_cache_sim", fault(ops.mesi_cache_sim))
    out = run_line(small_sweep_cell())
    assert out["correct"] is False and out["failed"] > 0


def test_sweep_sound_run_is_correct():
    assert run_line(small_sweep_cell())["correct"] is True


# ---- the tiering cell: K3 (ops.mesi_dyn_segment) ----------------------------
def _k3_unchanged(real):
    def k3(carry, addr, *a, **kw):
        b, e, _ = addr.shape
        ns = carry[2].shape[1]
        zeros = torch.zeros((b, e, 4 + ns), dtype=torch.int32)
        return (tuple(x.clone() for x in carry), zeros[..., :4],
                zeros[..., 4:], torch.ones((b, e), dtype=torch.int32))
    return k3


def _k3_half_batch(real):
    def k3(carry, addr, *a, **kw):
        carry, slots, snaps, meas = real(carry, addr, *a, **kw)
        h = max(addr.shape[0] // 2, 1)
        stats = carry[2].clone()
        stats[h:] = stats[:h].float().mean(dim=0).round().to(stats.dtype)
        return (carry[:2] + (stats,) + carry[3:], slots, snaps, meas)
    return k3


def _k3_altered(real):
    def k3(carry, addr, *a, **kw):
        carry, slots, snaps, meas = real(carry, addr, *a, **kw)
        stats = carry[2].clone()
        stats[-1, 3] += 1                 # one more L2 miss in the last row
        return (carry[:2] + (stats,) + carry[3:], slots, snaps, meas)
    return k3


@pytest.mark.parametrize("fault", [_k3_unchanged, _k3_half_batch,
                                   _k3_altered])
def test_tiering_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "mesi_dyn_segment", fault(ops.mesi_dyn_segment))
    out = run_line(small_tiering_cell())
    assert out["correct"] is False and out["failed"] > 0


def test_tiering_sound_run_is_correct():
    assert run_line(small_tiering_cell())["correct"] is True


# ---- the serving cell: decode_step and K4 ------------------------------------
def _step_unchanged(tf, ops):
    real = tf.decode_step

    def step(params, cfg, token, caches, ctx_len, *a, **kw):
        scratch = [[{b: {k: v.clone() for k, v in e.items()}
                     for b, e in period.items()} for period in seg]
                   for seg in caches]
        logits, _ = real(params, cfg, token, scratch, ctx_len, *a, **kw)
        return logits, caches             # the cache never advances
    return "decode_step", tf, step


def _k4_half_batch(tf, ops):
    real = ops.paged_attention

    def k4(q, kp, vp, bt, cl):
        h = max(q.shape[0] // 2, 1)
        out = real(q[:h], kp, vp, bt[:h], cl[:h])
        rest = out.mean(dim=0, keepdim=True).expand(q.shape[0] - h, -1, -1)
        return torch.cat([out, rest])
    return "paged_attention", ops, k4


def _token_altered(tf, ops):
    real = tf.decode_step
    calls = [0]

    def step(params, cfg, token, caches, ctx_len, *a, **kw):
        logits, caches = real(params, cfg, token, caches, ctx_len, *a, **kw)
        calls[0] += 1
        if calls[0] % 5 == 0:             # every fifth token is another one
            logits = logits.clone()
            top = int(torch.argmax(logits[0, 0]))
            logits[0, 0, (top + 1) % logits.shape[-1]] = logits.max() + 1
        return logits, caches
    return "decode_step", tf, step


@pytest.mark.parametrize("fault", [_step_unchanged, _k4_half_batch,
                                   _token_altered])
def test_serve_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    name, mod, fn = fault(tf, ops)
    monkeypatch.setattr(mod, name, fn)
    out = run_line(small_serve_cell())
    assert out["correct"] is False and out["failed"] > 0


def test_serve_sound_run_is_correct():
    assert run_line(small_serve_cell())["correct"] is True
