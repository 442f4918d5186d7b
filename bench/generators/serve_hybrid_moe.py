"""Generator of closed-loop serving for a model of window and full attention
layers over sparse experts, as one expert-parallel rank holds it
(MiMo-V2-Flash): the ``serve_mla_moe`` generator's batches through
``launch.serve.run``, with this model's configuration, parameter tree and
comparison.

The configuration file holds the model's ``config.json`` keys (the held
experts under ``n_routed_experts``, the router's width and the first held
expert under ``expert_parallel``); the weights come from ``--seed`` (the
reference's :func:`make_params`).  The routes are recorded and compared as
``serve_mla_moe`` does (``route_mismatch``).  The serving loop's pool holds
two kinds of page, its first full layer's and its first window layer's
rings; each step launches K4 once per kind, and ``attn_err`` holds both
kinds' outputs against the reference's attention over the rows of those
layers (the window kind's over the last window of positions, with the
layer's sinks); ``kv_mismatch`` counts the pool's counters, summed and per
kind, that differ from the reference's two-kind accounting.

``counters()`` adds the prefill's and the decode's held assignments of
each batch and the attention layers of each kind (for the FLOP counts), each traced K4 call's
shapes (for the roofline share) and the program's spans of the traced
stretch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from harness.core import BENCH, load_module
from harness.trace import ranged

mla = load_module(BENCH / "generators" / "serve_mla_moe.py",
                  "bench_serve_hybrid_moe_")


def program_config(m: Dict):
    """The program's configuration of `m`: its architecture's, with every
    size, both attention kinds, the gate and the held share of the
    configuration file put in."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HybridAttention, MoEConfig

    if (m["swa_head_dim"], m["swa_v_head_dim"],
            m["swa_num_attention_heads"]) != (
            m["head_dim"], m["v_head_dim"], m["num_attention_heads"]):
        raise ValueError("the window layers' head widths must be the full "
                         "layers'")
    layers, ep = m["num_hidden_layers"], m["expert_parallel"]
    freq = m["moe_layer_freq"][:layers]
    first_dense = freq.index(1)
    if 0 in freq[first_dense:]:
        raise ValueError("the MoE layers must follow the dense ones")
    return dataclasses.replace(
        get_config(m["program_arch"]),
        n_layers=layers, d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        v_head_dim=m["v_head_dim"],
        rotary_dim=int(m["head_dim"] * m["partial_rotary_factor"]),
        value_scale=float(m["attention_value_scale"]),
        attn_sinks=bool(m["add_full_attention_sink_bias"]),
        vocab_size=m["vocab_size"], norm_eps=m["layernorm_epsilon"],
        rope_theta=float(m["rope_theta"]), dtype=m["dtype"],
        tie_embeddings=m["tie_word_embeddings"],
        hybrid=HybridAttention(
            pattern=tuple(m["hybrid_layer_pattern"]),
            window=m["sliding_window"],
            n_kv_heads=m["swa_num_key_value_heads"],
            rope_theta=float(m["swa_rope_theta"]),
            sinks=bool(m["add_swa_attention_sink_bias"])),
        moe=MoEConfig(
            n_experts=ep["router_experts"], top_k=m["num_experts_per_tok"],
            n_shared=0, expert_d_ff=m["moe_intermediate_size"],
            first_dense=first_dense, dense_d_ff=m["intermediate_size"],
            scoring=m["scoring_func"], n_group=m["n_group"],
            topk_group=m["topk_group"],
            routed_scale=float(m["routed_scaling_factor"] or 1.0),
            score_bias=True,
            held=(ep["first_held_expert"], m["n_routed_experts"])))


def program_params(m: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The benchmark's weights in the program's parameter tree."""
    def block(i, ffn):
        attn = {"wqkv": w[f"l{i}.wqkv"], "wo": w[f"l{i}.wo"]}
        if f"l{i}.sinks" in w:
            attn["sinks"] = w[f"l{i}.sinks"]
        return {"b0": {"ln1": {"scale": w[f"l{i}.ln1"]}, "attn": attn,
                       "ln2": {"scale": w[f"l{i}.ln2"]}, **ffn}}
    layers = m["num_hidden_layers"]
    n_dense = m["moe_layer_freq"][:layers].index(1)
    dense = [block(i, {"mlp": {"wiu": w[f"l{i}.wiu"],
                               "wo": w[f"l{i}.wo_mlp"]}})
             for i in range(n_dense)]
    moe = [block(i, {"moe": {"router": w[f"l{i}.router"],
                             "bias": w[f"l{i}.bias"],
                             "wiu": w[f"l{i}.experts_wiu"],
                             "wo": w[f"l{i}.experts_wo"]}})
           for i in range(n_dense, layers)]
    return {"embed": {"table": w["embed"]},
            "final_norm": {"scale": w["final_norm"]},
            "head": {"w": w["head"]}, "segments": [dense, moe]}


mla.base.program_config = program_config
mla.base.program_params = program_params

KEEP = ("tokens", "kv_stats", "kv_kinds", "attn_out", "kind_attn_out",
        "prefill_s", "decode_s")


class Run(mla.Run):
    """One run of the cell: set-up, window, check."""

    def __init__(self, cell, seed: int, device: torch.device):
        # a program without both attention kinds fails here, at once
        cfg = program_config(cell.config)
        self.kinds = 2                  # the pool's full and window kinds
        self.attn_layers = {
            "full": sum(not cfg.is_window_layer(i)
                        for i in range(cfg.n_layers)),
            "window": sum(cfg.is_window_layer(i)
                          for i in range(cfg.n_layers))}
        super().__init__(cell, seed, device)

    def call(self, decode: int) -> Dict:
        self._graph_routes.clear()      # each call captures its own graphs
        t0 = time.perf_counter()
        out = self.serve.run(self.cfg, requests=self.tr["requests"],
                             prefill=self.tr["prefill"], decode=decode,
                             page_size=self.tr["page_size"],
                             hbm_pages=self.tr["hbm_pages"],
                             device=self.device, params=self.params)
        t1 = time.perf_counter()
        keep = {k: out[k] for k in KEEP}
        keep.update(t0=t0, t1=t1)
        self.calls.append(keep)
        return keep

    def traced(self, steps: int):
        """One more batch; `steps` of its decode steps, from the traffic's
        ``profile_from``, under the profiler, with each K4 launch (one per
        pool kind and step) in a ``bench.k4`` range."""
        from repro_torch.kernels import ops

        prof = mla.SpanProfile(self.device)
        first, per_step = self.tr["profile_from"], self.kinds
        self.k4_calls: List[Dict] = []
        n_k4 = [0]
        win = []

        def record(args, kwargs):
            q, kp, vp, bt, cl = args
            at = n_k4[0] // per_step
            if n_k4[0] == first * per_step:
                prof.start()
                win.append(prof.open_window())
            if n_k4[0] == (first + steps) * per_step:
                prof.close_window(win.pop())
                prof.stop()
            if first <= at < first + steps:
                self.k4_calls.append({
                    "q": tuple(q.shape), "q_bytes": q.element_size(),
                    "pages": tuple(kp.shape), "v_width": vp.shape[-1],
                    "kv_bytes": kp.element_size(), "blocks": bt.shape[1],
                    "sinks": kwargs.get("sinks") is not None, "ctx": cl})
            n_k4[0] += 1

        saved_k4 = ops.paged_attention
        ops.paged_attention = ranged(saved_k4, "k4", record)
        try:
            self.call(self.tr["decode"])["timed"] = False
        finally:
            ops.paged_attention = saved_k4
            if win:                       # the batch ended inside the stretch
                prof.close_window(win.pop())
                prof.stop()
        for c in self.k4_calls:
            c["ctx"] = [int(x) for x in c["ctx"].cpu()]
        self.traced_steps = steps
        self.spans = prof.spans
        return prof

    def counters(self) -> Dict:
        out = super().counters()
        out["attn_layers"] = dict(self.attn_layers)
        out["prefill_held"] = [self.prefill_held(c)
                               for c, call in enumerate(self.calls)
                               if call.get("timed", True)]
        return out

    def prefill_held(self, c: int) -> int:
        """Assignments to held experts in call `c`'s prefills."""
        at = self._first_route(c)
        first, n = self.cfg.moe.held
        return int(sum(((e >= first) & (e < first + n)).sum()
                       for e in self.routes[
                           at:at + self.tr["requests"] * self._moe_layers()]))

    # -- the comparison ------------------------------------------------------
    def _inputs(self):
        tr, m = self.tr, self.m
        return self.reference.serve_inputs(
            tr["requests"], tr["prefill"], tr["decode"], m["vocab_size"],
            m["num_attention_heads"], (m["head_dim"],) * self.kinds,
            tr["program_rng_seed"])

    def _moe_layers(self) -> int:
        return sum(self.m["moe_layer_freq"][:self.m["num_hidden_layers"]])

    def _attn_err(self, prompts, queries, precision, program
                  ) -> Dict[int, float]:
        """Per batch, K4's output of every step and pool kind against the
        reference's attention over the pool the loop fills: the kind's
        layer's prompt keys and values, then a zero row per decoded token,
        the window kind over the last window of them with the layer's sinks
        (for the control, one entry: the reference over float8 pools)."""
        ref, m, dev, tr = self.reference, self.m, self.device, self.tr
        window = (None, m["sliding_window"])
        err = {c: 0.0 for c in range(len(self.calls) if program else 1)}
        for j, layer in enumerate(ref.pool_layers(m)):
            rows = [ref.pool_rows(m, self.weights,
                                  torch.as_tensor(p, device=dev), layer)
                    for p in prompts]
            pools = []
            for x in zip(*rows):
                x = torch.stack(x)
                pad = torch.zeros((x.shape[0], tr["decode"]) + x.shape[2:],
                                  device=dev)
                pools.append(torch.cat([x, pad], dim=1))
            del rows
            low = [ref.round_fp8(x) for x in pools]
            sinks = self.weights.get(f"l{layer}.sinks")
            for i, step in enumerate(queries):
                qd = torch.as_tensor(step[j], device=dev)
                n_ctx = tr["prefill"] + i
                want = ref.pool_attention(qd, *pools, n_ctx, window[j],
                                          sinks)
                if program:
                    for c, call in enumerate(self.calls):
                        if i < len(call["attn_out"]):
                            err[c] = max(err[c], ref.max_rel_err(
                                call["kind_attn_out"][j][i], want))
                else:
                    got = ref.pool_attention(qd, *low, n_ctx, window[j],
                                             sinks)
                    err[0] = max(err[0], ref.max_rel_err(got, want))
        return err

    def _kv_mismatch(self) -> Dict[int, int]:
        """Per batch, the KV counters, summed and per kind (with each
        kind's live pages), that differ from the reference's two-kind
        accounting (the simulated seconds beyond a billionth)."""
        tr, m, ref = self.tr, self.m, self.reference
        kinds = [{"page_bytes": ref.page_bytes(m, tr["page_size"], False),
                  "ring": None},
                 {"page_bytes": ref.page_bytes(m, tr["page_size"], True),
                  "ring": ref.ring_pages(m, tr["page_size"])}]
        rd, wr = ref.cxl_payload_gbps(tr["cxl"])

        def differ(got, want):
            return sum(abs(got[k] - v) > 1e-9 * abs(v)
                       if k == "sim_seconds" else got[k] != v
                       for k, v in want.items())
        out = {}
        for c, call in enumerate(self.calls):
            want = ref.kv_accounting(
                tr["requests"], tr["prefill"], len(call["attn_out"]),
                tr["page_size"], tr["hbm_pages"], kinds, rd, wr)
            got = call["kv_kinds"]
            out[c] = differ(call["kv_stats"], want["total"]) + sum(
                differ(got[name], w) if name in got else len(w)
                for name, w in zip(("full", "window"), want["kinds"]))
        return out
