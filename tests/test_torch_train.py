"""The port's training path against the JAX package, on the CPU at smoke
size: ``forward_train``, the loss and its gradients, ``make_train_step``,
AdamW, the gradient codec, the data pipeline, the training runtime, the
elastic grid math, checkpoints of a training state and
``launch.train.run``.

Inputs come from numpy seeds; weights are the JAX ``init_params`` tree
carried over with :func:`repro_torch.convert.model_params`.  Tolerances
(those of ``test_torch_models``): forward values rtol = atol = 1e-5 in
float32, rtol 2e-2 / atol 6e-2 in bfloat16; gradients and Adam state
after several steps rtol 1e-4 / atol 1e-5 in float32 (the two packages
sum in different orders, and a step's update divides by sqrt(v), which
carries a gradient's rounding into the parameters).  Tokens, the gradient
codec and the checkpoint's structure string are compared bit for bit.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as jdata
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.runtime import fault as jfault
from repro.runtime import elastic as jelastic
from repro_torch import convert
from repro_torch import tree as ttree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault as tfault

from test_torch_models import TOL, close, f32

DENSE = ["h2o-danube-3-4b", "granite-3-8b", "stablelm-12b", "starcoder2-3b",
         "qwen2-vl-2b", "musicgen-large"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
jforward = jax.jit(jtf.forward_train, static_argnums=(1,))


def configs(arch, dtype="float32", **over):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(tget_smoke(arch), dtype=dtype, **over))


def carried(jcfg, tcfg, seed):
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jparams, convert.model_params(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def jleaf(jtree, path):
    """The JAX leaf that the port's leaf at `path` is a slice of: a leaf
    under ``segments`` is one period of the reference's stacked leaf."""
    if path and path[0] == "segments":
        seg, period, rest = path[1], path[2], path[3:]
        node = jtree["segments"][seg]
        for k in rest:
            node = node[k]
        return np.asarray(jnp.asarray(node, jnp.float32))[period]
    node = jtree
    for k in path:
        node = node[k]
    return node


def close_trees(jtree, ttree_, **tol):
    pairs = ttree.leaves_with_path(ttree_)
    assert pairs
    for path, leaf in pairs:
        np.testing.assert_allclose(f32(leaf), f32(jleaf(jtree, path)),
                                   err_msg=str(path), **tol)


def batch(cfg, b, s, seed):
    """The same batch for both packages: tokens, M-RoPE positions and a
    vision prefix where the arch takes them."""
    rng = np.random.default_rng(seed)
    lead = (b,) if cfg.n_codebooks == 1 else (b, cfg.n_codebooks)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (s,))
           .astype(np.int32)}
    if cfg.rope == "mrope":
        out["positions"] = np.stack([np.broadcast_to(
            np.arange(s, dtype=np.int32), (b, s))] * 3)
    if cfg.vision_tokens:
        out["vision"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in out.items()})


# ---------------------------------------------------------------------------
# forward_train, loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_jax(arch, dtype):
    jcfg, tcfg = configs(arch, dtype)
    jparams, tparams = carried(jcfg, tcfg, 1)
    jb, tb = batch(jcfg, 2, 20, 3)
    jl, jaux = jforward(jparams, jcfg, jb["tokens"],
                        jb.get("positions"), jb.get("vision"))
    tl, taux = ttf.forward_train(tparams, tcfg, tb["tokens"],
                                 tb.get("positions"), tb.get("vision"))
    assert tl.shape == jl.shape and tl.dtype == getattr(torch, dtype)
    close(jl, tl, dtype)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_loss_and_grads_match_jax(arch):
    """`loss_fn` and its gradients against ``jax.value_and_grad``: the text,
    vision (M-RoPE) and codebook branches; gradients in each parameter's
    dtype, with and without "dots" remat (same values)."""
    jcfg, tcfg = configs(arch)
    jparams, tparams = carried(jcfg, tcfg, 2)
    jb, tb = batch(jcfg, 2, 20, 4)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, jcfg, bt), has_aux=True))(
        jparams, jb)
    tloss, tgrads = tmodel.value_and_grad(tparams, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _, tm = tmodel.loss_fn(tparams, tcfg, tb)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    close_trees(jgrads, tgrads, **GRAD_TOL)
    for path, g in ttree.leaves_with_path(tgrads):
        p = tparams
        for k in path:
            p = p[k]
        assert g.dtype == p.dtype and g.shape == p.shape, path
    other = dataclasses.replace(
        tcfg, remat_policy="none" if tcfg.remat_policy == "dots" else "dots")
    _, again = tmodel.value_and_grad(tparams, other, tb)
    for a, b in zip(ttree.leaves(tgrads), ttree.leaves(again)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_grads_match_jax():
    jcfg, tcfg = configs("h2o-danube-3-4b", "bfloat16")
    jparams, tparams = carried(jcfg, tcfg, 2)
    jb, tb = batch(jcfg, 2, 20, 5)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, jcfg, bt)[0]))(jparams, jb)
    tloss, tgrads = tmodel.value_and_grad(tparams, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
    assert tgrads["embed"]["table"].dtype == torch.bfloat16
    assert tgrads["final_norm"]["scale"].dtype == torch.float32
    close_trees(jgrads, tgrads, **TOL["bfloat16"])


def stacked(tree):
    """The port's tree in the reference's layout (periods stacked)."""
    out = {k: v for k, v in tree.items() if k != "segments"}
    out["segments"] = [ttree.tree_map(lambda *ps: torch.stack(ps), *seg)
                       for seg in tree["segments"]]
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """Three steps of `make_train_step`: loss, grad norm, lr, parameters and
    both moments (float32), at the launcher's learning rate (an update is
    about lr in size whatever the gradient's, so a gradient near Adam's
    eps turns its last-ulp differences into differences of lr's order)."""
    jcfg, tcfg = configs("h2o-danube-3-4b")
    jparams, tparams = carried(jcfg, tcfg, 3)
    opt = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jmodel.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                           accum))
    tstep = tmodel.make_train_step(tcfg, tadamw.AdamWConfig(**opt), accum)
    jopt, topt = jadamw.init(jparams), tadamw.init(tparams)
    for i in range(3):
        jb, tb = batch(jcfg, 4, 16, 10 + i)
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        tparams, topt, tm = tstep(tparams, topt, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    assert int(topt.step) == int(jopt.step) == 3
    close_trees(jparams, tparams, **GRAD_TOL)
    close_trees(jopt.m, topt.m, **GRAD_TOL)
    close_trees(jopt.v, topt.v, **GRAD_TOL)
    # the state carries over: the port continues from JAX's moments
    carried_opt = convert.opt_state(
        tcfg, jax.tree_util.tree_map(np.asarray, jopt), device="cpu")
    assert isinstance(carried_opt, tadamw.OptState)
    close_trees(jopt.v, carried_opt.v, rtol=0, atol=0)
    assert jax.tree.structure(stacked(carried_opt.m)).num_leaves == \
        jax.tree.structure(jopt.m).num_leaves


def test_accumulation_sums_in_the_parameters_dtype(monkeypatch):
    """With bf16 parameters the microbatch gradients are summed and divided
    in bf16 (the reference's ``zeros_like(params)`` carry)."""
    _, tcfg = configs("h2o-danube-3-4b", "bfloat16")
    tparams = ttf.init_params(tcfg, torch.Generator().manual_seed(4), "cpu")
    _, tb = batch(tcfg, 4, 12, 6)
    seen = {}

    def capture(cfg, grads, state, params):
        seen["grads"] = grads
        return params, state, {}
    monkeypatch.setattr(tadamw, "update", capture)
    step = tmodel.make_train_step(tcfg, tadamw.AdamWConfig(), 2)
    step(tparams, tadamw.init(tparams), tb)
    halves = [tmodel.value_and_grad(
        tparams, tcfg, {k: v[2 * i:2 * i + 2] for k, v in tb.items()})[1]
        for i in range(2)]
    for got, g0, g1 in zip(*map(ttree.leaves, (seen["grads"], *halves))):
        assert got.dtype == g0.dtype
        assert torch.equal(got, (g0 + g1) / 2)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_adamw_update_matches_jax():
    """Three updates of a tree with the port's layout: decay by the
    reference's (stacked) rank — the norm scales under ``segments`` are
    decayed, ``final_norm`` is not — and clipping (grad norm > clip)."""
    rng = np.random.default_rng(0)
    d, n_p = 8, 2
    seg = {"b0": {"ln1": {"scale": rng.standard_normal((n_p, d))},
                  "w": rng.standard_normal((n_p, d, 3))}}
    jtree = {"embed": {"table": rng.standard_normal((5, d))},
             "final_norm": {"scale": rng.standard_normal((d,))},
             "segments": [seg]}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jtree)
    own = lambda a: torch.from_numpy(np.array(a))        # noqa: E731
    jseg = jtree["segments"][0]["b0"]
    ttree_ = {"embed": {"table": own(jtree["embed"]["table"])},
              "final_norm": {"scale": own(jtree["final_norm"]["scale"])},
              "segments": [[{"b0": {
                  "ln1": {"scale": own(jseg["ln1"]["scale"][i])},
                  "w": own(jseg["w"][i])}} for i in range(n_p)]]}
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=6, grad_clip=0.5)
    jstate, tstate = jadamw.init(jtree), tadamw.init(ttree_)
    for i in range(3):
        gnp = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                           .astype(np.float32), jtree)
        tg = ttree.unflatten(ttree_, [torch.from_numpy(np.array(
            jleaf(gnp, path))) for path, _ in
            ttree.leaves_with_path(ttree_)])
        jtree, jstate, jm = jadamw.update(jadamw.AdamWConfig(**cfg), gnp,
                                          jstate, jtree)
        ttree_, tstate, tm = tadamw.update(tadamw.AdamWConfig(**cfg), tg,
                                           tstate, ttree_)
        assert float(tm["grad_norm"]) > cfg["grad_clip"]
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    close_trees(jtree, ttree_, **GRAD_TOL)
    close_trees(jstate.m, tstate.m, **GRAD_TOL)
    close_trees(jstate.v, tstate.v, **GRAD_TOL)
    # zero gradients leave only the decay: the stacked (P, d) norm scales
    # shrink, final_norm's (d,) scale does not
    zeros = ttree.tree_map(torch.zeros_like, ttree_)
    fresh = tadamw.init(ttree_)
    before = ttree.tree_map(torch.clone, ttree_)
    after, _, _ = tadamw.update(tadamw.AdamWConfig(lr=0.1, warmup_steps=1),
                                zeros, fresh, ttree_)
    assert torch.equal(after["final_norm"]["scale"],
                       before["final_norm"]["scale"])
    for name in ("ln1", "w"):
        a = after["segments"][0][1]["b0"][name]
        a = a["scale"] if name == "ln1" else a
        b = before["segments"][0][1]["b0"][name]
        b = b["scale"] if name == "ln1" else b
        assert (a.abs() < b.abs()).all(), name


def test_adamw_update_leaves_the_gradients_unchanged():
    """Clipping scales a copy: f32 gradients (the norm scales, the router,
    every leaf of an f32 config) are not rescaled in place."""
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn((4, 3), generator=gen),
              "ln": {"scale": torch.randn((3,), generator=gen)}}
    grads = ttree.tree_map(lambda p: 10 * torch.randn(p.shape, generator=gen),
                           params)
    before = ttree.tree_map(torch.clone, grads)
    _, _, m = tadamw.update(tadamw.AdamWConfig(grad_clip=1.0), grads,
                            tadamw.init(params), params)
    assert float(m["grad_norm"]) > 1.0
    for a, b in zip(ttree.leaves(grads), ttree.leaves(before)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step,want", [(5, 0.5), (10, 1.0), (100, 0.1)])
def test_lr_schedule_points(step, want):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = tadamw.lr_at(tadamw.AdamWConfig(**cfg),
                       torch.tensor(step, dtype=torch.int32))
    ref = jadamw.lr_at(jadamw.AdamWConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want)
    assert float(got) == float(ref)


# ---------------------------------------------------------------------------
# gradient codec, data, runtime, elastic
# ---------------------------------------------------------------------------
def test_compress_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((17, 5)).astype(np.float32),
             "b": [rng.standard_normal((3,)).astype(np.float32) * 1e-3,
                   np.zeros((4,), np.float32)]}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = ttree.tree_map(torch.from_numpy, grads)
    jef, tef = jcompress.init_error_feedback(jg), \
        tcompress.init_error_feedback(tg)
    for _ in range(2):
        jc, jef = jcompress.compress(jg, jef)
        tc, tef = tcompress.compress(tg, tef)
        for j, t in ((jc.q, tc.q), (jc.scale, tc.scale), (jef, tef),
                     (jcompress.decompress(jc, jg),
                      tcompress.decompress(tc, tg))):
            for a, b in zip(jax.tree.leaves(j), ttree.leaves(t)):
                assert np.asarray(a).dtype == b.numpy().dtype
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tcompress.wire_bytes(tg) == jcompress.wire_bytes(jg)


@pytest.mark.parametrize("arch", ["granite-3-8b", "musicgen-large",
                                  "qwen2-vl-2b"])
def test_batch_at_step_matches_jax_bit_for_bit(arch):
    jcfg, tcfg = jget_smoke(arch), tget_smoke(arch)
    for step, shard in ((0, 0), (7, 1)):
        dc = dict(batch_per_shard=3, seq_len=24, shard_id=shard)
        want = jdata.batch_at_step(jcfg, jdata.DataConfig(**dc), step)
        got = tdata.batch_at_step(tcfg, tdata.DataConfig(**dc), step,
                                  device="cpu")
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            if k == "vision":
                assert got[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got[k].view(torch.int16).numpy(), w.view(np.int16))
            else:
                np.testing.assert_array_equal(got[k].numpy(), w)
    it = tdata.iterate(tcfg, tdata.DataConfig(), 3, device="cpu")
    assert torch.equal(next(it)["tokens"], tdata.batch_at_step(
        tcfg, tdata.DataConfig(), 3, device="cpu")["tokens"])


def _counting_step(state, step):
    return {"x": state["x"] + 1}, {"loss": 1.0 / (step + 1)}


def _without_dt(log):
    return [{k: v for k, v in e.items() if k != "dt"} for e in log]


def test_runtime_restart_log_matches_jax(tmp_path):
    """The counting step of test_substrates: a failure at step 25 with a
    checkpoint every 10 replays from step 20, on both sides."""
    def injector_for(failure):
        fired = {"done": False}

        def injector(step):
            if step == 25 and not fired["done"]:
                fired["done"] = True
                raise failure(host=2)
        return injector

    jrt = jfault.TrainingRuntime(
        _counting_step, JCheckpointManager(tmp_path / "j"),
        jfault.RuntimeConfig(ckpt_every=10), n_hosts=4,
        failure_injector=injector_for(jfault.WorkerFailure))
    jstate, jend = jrt.run({"x": jnp.int32(0)}, 0, 40)
    trt = tfault.TrainingRuntime(
        _counting_step, CheckpointManager(tmp_path / "t"),
        tfault.RuntimeConfig(ckpt_every=10), n_hosts=4,
        failure_injector=injector_for(tfault.WorkerFailure))
    tstate, tend = trt.run({"x": torch.tensor(0, dtype=torch.int32)}, 0, 40)
    assert tend == jend == 40 and trt.restarts == jrt.restarts == 1
    assert int(tstate["x"]) == int(jstate["x"]) == 40
    assert trt.fleet.evicted == jrt.fleet.evicted == [2]
    assert _without_dt(trt.log) == _without_dt(jrt.log)
    assert {"evict", "restart"} <= {e["event"] for e in trt.log}


def test_runtime_straggler_log_matches_jax(tmp_path):
    def timings(step):
        return [1.0, 1.0, 1.0, 9.0]          # host 3 is slow

    cfg = dict(ckpt_every=100, straggler_grace=3)
    jrt = jfault.TrainingRuntime(
        _counting_step, JCheckpointManager(tmp_path / "j"),
        jfault.RuntimeConfig(**cfg), n_hosts=4, host_timings_fn=timings)
    jrt.run({"x": jnp.int32(0)}, 0, 10)
    resized = []
    trt = tfault.TrainingRuntime(
        _counting_step, CheckpointManager(tmp_path / "t"),
        tfault.RuntimeConfig(**cfg), n_hosts=4, host_timings_fn=timings,
        on_resize=resized.append)
    trt.run({"x": torch.tensor(0, dtype=torch.int32)}, 0, 10)
    assert trt.fleet.evicted == jrt.fleet.evicted == [3]
    assert _without_dt(trt.log) == _without_dt(jrt.log)
    assert trt.fleet.step_time_ewma == pytest.approx(
        jrt.fleet.step_time_ewma)
    assert resized == [3]


def test_restart_budget_is_enforced(tmp_path):
    def always(step):
        raise tfault.WorkerFailure(host=0)
    rt = tfault.TrainingRuntime(_counting_step, CheckpointManager(tmp_path),
                                tfault.RuntimeConfig(max_restarts=2),
                                failure_injector=always)
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        rt.run({"x": torch.tensor(0)}, 0, 3)
    assert rt.restarts == 3


@pytest.mark.parametrize("live,model", [(256, 16), (240, 16), (8, 16),
                                        (7, 1), (1, 1)])
def test_shrink_data_axis_matches_jax(live, model):
    try:
        want = jelastic.shrink_data_axis(live, model)
    except ValueError:
        with pytest.raises(ValueError, match="TP group"):
            telastic.shrink_data_axis(live, model)
        return
    assert telastic.shrink_data_axis(live, model) == want
    assert telastic.largest_pow2_leq(live) == jelastic.largest_pow2_leq(live)


def test_remesh_is_a_device_grid():
    grid = telastic.remesh(["cpu"] * 6, 2, 2)
    assert [[d.type for d in row] for row in grid] == [["cpu"] * 2] * 2
    with pytest.raises(ValueError, match="devices for a"):
        telastic.remesh(["cpu"] * 3, 2, 2)


# ---------------------------------------------------------------------------
# checkpoints of a training state
# ---------------------------------------------------------------------------
def test_training_state_checkpoint_structure_and_round_trip(tmp_path):
    """(params, OptState): the manifest's structure string is JAX's
    ``str(treedef)`` for the same tree shape, and the state comes back
    bitwise (bf16 parameters, f32 moments, the int32 step)."""
    tcfg = tget_smoke("h2o-danube-3-4b")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    opt = tadamw.init(params)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       m=ttree.tree_map(lambda x: x + 0.5, opt.m))
    state = (params, opt)

    def as_jax(node):
        if isinstance(node, tadamw.OptState):
            return jadamw.OptState(*(as_jax(v) for v in node))
        if isinstance(node, dict):
            return {k: as_jax(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(as_jax(v) for v in node)
        return np.zeros(())
    assert _flatten(state)[1] == str(jax.tree.structure(as_jax(state)))
    assert "CustomNode(namedtuple[OptState], [*, {" in _flatten(state)[1]

    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(7, state, blocking=False)
    mgr.wait()
    like = ttree.tree_map(torch.zeros_like, state)
    step, back = mgr.restore(None, like)
    assert step == 7 and isinstance(back[1], tadamw.OptState)
    for a, b in zip(ttree.leaves(state), ttree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_is_not_changed_by_in_place_updates(tmp_path,
                                                      monkeypatch):
    """A ``blocking=False`` save of CPU tensors holds its own host copies:
    the tree is updated in place (as AdamW updates it) while the writer
    is held back, and the checkpoint still restores the saved values."""
    release = threading.Event()
    real_save = np.save

    def held_save(*args, **kwargs):
        release.wait()
        real_save(*args, **kwargs)
    monkeypatch.setattr(np, "save", held_save)
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((4, 3), generator=gen).bfloat16(),
            "v": torch.randn((5,), generator=gen),
            "n": np.arange(6, dtype=np.int32)}
    saved = ttree.tree_map(lambda x: x.clone() if isinstance(
        x, torch.Tensor) else x.copy(), tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree, blocking=False)
    tree["w"].add_(1.0)
    tree["v"].mul_(-2.0)
    tree["n"] += 7
    release.set()
    mgr.wait()
    _, back = mgr.restore(1, saved)
    assert torch.equal(back["w"], saved["w"])
    assert torch.equal(back["v"], saved["v"])
    np.testing.assert_array_equal(back["n"], saved["n"])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def _reference_loop(jcfg, jparams, *, steps, batch_, seq, accum, fail_at,
                    ckpt_every, ckpt_dir):
    """The reference's ``launch/train.py:main`` step loop, on one device."""
    opt_cfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    dc = jdata.DataConfig(batch_per_shard=batch_, seq_len=seq)
    step_impl = jax.jit(jmodel.make_train_step(jcfg, opt_cfg,
                                               accum_steps=accum))

    def step_fn(state, step):
        params, opt_state = state
        params, opt_state, metrics = step_impl(
            params, opt_state, jdata.batch_at_step(jcfg, dc, step))
        return (params, opt_state), {k: float(v) for k, v in metrics.items()}

    pending = [fail_at]

    def injector(step):
        if pending[0] and step == pending[0]:
            pending[0] = 0
            raise jfault.WorkerFailure(host=1, msg="injected failure (demo)")
    rt = jfault.TrainingRuntime(step_fn, JCheckpointManager(ckpt_dir, keep=3),
                                jfault.RuntimeConfig(ckpt_every=ckpt_every),
                                n_hosts=4, failure_injector=injector)
    state, _ = rt.run((jparams, jadamw.init(jparams)), 0, steps)
    return rt, state


@pytest.mark.parametrize("accum,fail_at", [(1, 0), (2, 3)])
def test_train_run_matches_the_reference_loop(tmp_path, accum, fail_at):
    jcfg, tcfg = configs("h2o-danube-3-4b")
    jparams, tparams = carried(jcfg, tcfg, 0)
    kw = dict(steps=5, seq=16, fail_at=fail_at, ckpt_every=2)
    jrt, (jp, jopt) = _reference_loop(jcfg, jparams, batch_=4, accum=accum,
                                      ckpt_dir=tmp_path / "j", **kw)
    r = ttrain.run(tcfg, batch=4, accum_steps=accum, log_every=0,
                   ckpt_dir=str(tmp_path / "t"), device="cpu",
                   params=tparams, **kw)
    assert r["restarts"] == jrt.restarts == (1 if fail_at else 0)
    assert r["end_step"] == 5 and r["evicted"] == jrt.fleet.evicted
    tlog, jlog = _without_dt(r["log"]), _without_dt(jrt.log)
    assert [e["event"] for e in tlog] == [e["event"] for e in jlog]
    for te, je in zip(tlog, jlog):
        for k in je:
            if k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(te[k], je[k], rtol=1e-4)
            else:
                assert te[k] == je[k], k
    tp, topt = r["state"]
    close_trees(jp, tp, **GRAD_TOL)
    close_trees(jopt.v, topt.v, **GRAD_TOL)
    if fail_at:          # the replayed steps repeat their losses
        losses = {}
        for e in tlog:
            if e["event"] == "step":
                assert losses.setdefault(e["step"], e["loss"]) == e["loss"]
