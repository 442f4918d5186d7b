"""Generator of closed-loop serving for a latent-attention MoE model as one
expert-parallel rank holds it (DeepSeek-V3): the ``serve`` generator's
batches through ``launch.serve.run``, with this model's configuration,
parameter tree and comparison.

The configuration file holds the model's ``config.json`` keys (the held
experts under ``n_routed_experts``, the router's width and the first held
expert under ``expert_parallel``); the weights come from ``--seed``
(the reference's :func:`make_params`).  Beyond the ``serve`` generator's
readings, the benchmark records each MoE layer's routing where the program
makes it (by wrapping ``models.moe.gate``; in a decode step replayed from
CUDA graphs, the gate's outputs that the capture recorded, copied after
each replay), and the comparison counts the held assignments that differ
from the reference's own routing of the same sequence
(``route_mismatch``).  K4 runs over the latent pool, held against
the reference's attention over layer 0's latent rows; the pool's counters
against the reference's accounting at the latent's page bytes.

``counters()`` adds the decode's held assignments of each batch (for the
FLOP count), counted from those recorded routes, and the program's spans
of the traced stretch, reduced by ``harness.spans.reduce_spans``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List

import torch

from harness.core import BENCH, load_module
from harness.spans import reduce_spans
from harness.trace import Profile, reduce_trace

base = load_module(BENCH / "generators" / "serve.py", "bench_serve_mla_moe_")


def program_config(m: Dict):
    """The program's configuration of `m`: its architecture's, with every
    size, the gate, YaRN and the held share of the configuration file put
    in."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig, MoEConfig, YarnConfig

    ys, ep = m["rope_scaling"], m["expert_parallel"]
    fe = m["moe_intermediate_size"]
    return dataclasses.replace(
        get_config(m["program_arch"]),
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"],
        head_dim=m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
        vocab_size=m["vocab_size"], norm_eps=m["rms_norm_eps"],
        rope_theta=float(m["rope_theta"]), dtype=m["dtype"],
        tie_embeddings=m["tie_word_embeddings"],
        rope_scaling=YarnConfig(
            factor=float(ys["factor"]),
            original_max_position=ys["original_max_position_embeddings"],
            beta_fast=float(ys["beta_fast"]),
            beta_slow=float(ys["beta_slow"]), mscale=float(ys["mscale"]),
            mscale_all_dim=float(ys["mscale_all_dim"])),
        mla=MLAConfig(q_lora_rank=m["q_lora_rank"],
                      kv_lora_rank=m["kv_lora_rank"],
                      qk_nope_head_dim=m["qk_nope_head_dim"],
                      qk_rope_head_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"]),
        moe=MoEConfig(
            n_experts=ep["router_experts"], top_k=m["num_experts_per_tok"],
            n_shared=m["n_shared_experts"], expert_d_ff=fe, shared_d_ff=fe,
            first_dense=m["first_k_dense_replace"],
            dense_d_ff=m["intermediate_size"], scoring=m["scoring_func"],
            n_group=m["n_group"], topk_group=m["topk_group"],
            routed_scale=float(m["routed_scaling_factor"]), score_bias=True,
            held=(ep["first_held_expert"], m["n_routed_experts"])))


def program_params(m: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The benchmark's weights in the program's parameter tree."""
    def attn(i):
        return {"wq_a": w[f"l{i}.wq_a"],
                "q_norm": {"scale": w[f"l{i}.q_norm"]},
                "wq_b": w[f"l{i}.wq_b"], "wkv_a": w[f"l{i}.wkv_a"],
                "kv_norm": {"scale": w[f"l{i}.kv_norm"]},
                "wkv_b": w[f"l{i}.wkv_b"], "wo": w[f"l{i}.wo"]}

    def block(i, ffn):
        return {"b0": {"ln1": {"scale": w[f"l{i}.ln1"]}, "attn": attn(i),
                       "ln2": {"scale": w[f"l{i}.ln2"]}, **ffn}}
    n_dense = m["first_k_dense_replace"]
    dense = [block(i, {"mlp": {"wiu": w[f"l{i}.wiu"],
                               "wo": w[f"l{i}.wo_mlp"]}})
             for i in range(n_dense)]
    moe = [block(i, {"moe": {"router": w[f"l{i}.router"],
                             "bias": w[f"l{i}.bias"],
                             "wiu": w[f"l{i}.experts_wiu"],
                             "wo": w[f"l{i}.experts_wo"],
                             "shared": {"wiu": w[f"l{i}.shared_wiu"],
                                        "wo": w[f"l{i}.shared_wo"]}}})
           for i in range(n_dense, m["num_hidden_layers"])]
    return {"embed": {"table": w["embed"]},
            "final_norm": {"scale": w["final_norm"]},
            "head": {"w": w["head"]}, "segments": [dense, moe]}


class SpanProfile(Profile):
    """A :class:`harness.trace.Profile` that also reduces the program's
    spans of its stretch (``self.spans``)."""

    spans: Dict = {}

    def stop(self) -> None:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = reduce_trace(events)
        self.spans = reduce_spans(events)


base.program_config = program_config
base.program_params = program_params
base.Profile = SpanProfile


class Run(base.Run):
    """One run of the cell: set-up, window, check."""

    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.models import moe
        from repro_torch.models import transformer as tf

        flat = cell.config
        cell = copy.copy(cell)
        cell.config = dict(flat, model=flat)
        self.moe, self.tf = moe, tf
        # each MoE layer's experts (T, k), in call order
        self.routes: List[torch.Tensor] = []
        # the experts a capture recorded, which each replay rewrites: the
        # capture's not yet replayed, and each call's by its StepGraph
        self._captured: List[torch.Tensor] = []
        self._graph_routes: Dict[int, List[torch.Tensor]] = {}
        real, real_decode = moe.gate, tf.decode_step

        def gate(*args, **kwargs):
            weights, experts = real(*args, **kwargs)
            if experts.is_cuda and torch.cuda.is_current_stream_capturing():
                self._captured.append(experts)
            else:
                self.routes.append(experts)
            return weights, experts

        def decode_step(params, cfg, token, caches, *args, **kwargs):
            out = real_decode(params, cfg, token, caches, *args, **kwargs)
            if getattr(caches, "graph", None) is not None:
                if id(caches) not in self._graph_routes:
                    self._graph_routes[id(caches)] = self._captured
                    self._captured = []
                replayed = self._graph_routes[id(caches)]
                if replayed:
                    self.routes.extend(torch.stack(replayed).unbind(0))
            return out

        self._gate, self._decode_step = real, real_decode
        moe.gate, tf.decode_step = gate, decode_step
        super().__init__(cell, seed, device)
        self.routes.clear()

    def call(self, decode: int) -> Dict:
        self._graph_routes.clear()      # each call captures its own graphs
        t0 = time.perf_counter()
        out = self.serve.run(self.cfg, requests=self.tr["requests"],
                             prefill=self.tr["prefill"], decode=decode,
                             page_size=self.tr["page_size"],
                             hbm_pages=self.tr["hbm_pages"],
                             device=self.device, params=self.params)
        t1 = time.perf_counter()
        keep = {k: out[k] for k in ("tokens", "kv_stats", "attn_out",
                                    "prefill_s", "decode_s")}
        keep.update(t0=t0, t1=t1)
        self.calls.append(keep)
        return keep

    def traced(self, steps: int):
        prof = super().traced(steps)
        self.spans = prof.spans
        return prof

    def counters(self) -> Dict:
        out = super().counters()
        out["decode_held"] = [self.decode_held(c)
                              for c, call in enumerate(self.calls)
                              if call.get("timed", True)]
        out["spans"] = getattr(self, "spans", {})
        return out

    def release(self) -> None:
        super().release()
        self.moe.gate, self.tf.decode_step = self._gate, self._decode_step

    # -- the comparison ------------------------------------------------------
    def _inputs(self):
        tr, m = self.tr, self.m
        return self.reference.serve_inputs(
            tr["requests"], tr["prefill"], tr["decode"], m["vocab_size"],
            m["num_attention_heads"], self.reference.latent_width(m),
            tr["program_rng_seed"])

    def _moe_layers(self) -> int:
        return self.m["num_hidden_layers"] - self.m["first_k_dense_replace"]

    def _first_route(self, c: int) -> int:
        """Index in ``routes`` of call `c`'s first gate call: each call
        routes every request's prefill, then every decode step, layer by
        layer."""
        R, L = self.tr["requests"], self._moe_layers()
        return sum(R * L * (1 + len(call["attn_out"]))
                   for call in self.calls[:c])

    def decode_held(self, c: int) -> int:
        """Assignments to held experts in call `c`'s decode steps."""
        R, L = self.tr["requests"], self._moe_layers()
        at = self._first_route(c) + R * L
        first, n = self.cfg.moe.held
        return int(sum(((e >= first) & (e < first + n)).sum()
                       for e in self.routes[
                           at:at + R * L * len(self.calls[c]["attn_out"])]))

    def program_routes(self, c: int, r: int) -> List[torch.Tensor]:
        """Per MoE layer, the experts (P + D, k) the program chose for
        request `r` of call `c`: its prefill's, then each decode step's."""
        R, L = self.tr["requests"], self._moe_layers()
        at = self._first_route(c)
        D = len(self.calls[c]["attn_out"])
        pre = [self.routes[at + r * L + j] for j in range(L)]
        dec = at + R * L
        return [torch.cat([pre[j]] + [self.routes[dec + (i * R + r) * L + j]
                                      for i in range(D)])
                for j in range(L)]

    def readings(self, precision: str = "f32",
                 program: bool = True) -> Dict[str, float]:
        """As the ``serve`` generator's, with ``route_mismatch`` per sampled
        request: the held assignments that differ between the program's
        routing (or, for the control, the reference's in `precision`) and
        the float32 reference's own."""
        ref = self.reference
        m, tr, dev = self.m, self.tr, self.device
        prompts, queries = self._inputs()
        self.per_request = {}
        for c, r in self.sample():
            logits, toks = self.served(c, r)
            seq = torch.cat([torch.as_tensor(prompts[r], device=dev),
                             toks[:-1]])
            pos = range(tr["prefill"] - 1, seq.shape[0])
            want_routes: List[torch.Tensor] = []
            full = ref.forward(m, self.weights, seq, pos,
                               routes=want_routes)
            if program:
                got_routes = self.program_routes(c, r)
            else:
                got_routes = []
                logits = ref.forward(m, self.weights, seq, pos, precision,
                                     routes=got_routes)
                toks = logits.argmax(dim=-1)
            self.per_request[c, r] = {
                "token_gap": ref.greedy_gap(full, toks),
                "logit_err": ref.max_rel_err(logits, full),
                "route_mismatch": sum(
                    ref.held_mismatch(g, w, m)
                    for g, w in zip(got_routes, want_routes))}
        attn = self._attn_err(prompts, queries, precision, program)
        self.per_batch = {c: {"attn_err": a} for c, a in attn.items()}
        if program:
            for c, bad in self._kv_mismatch().items():
                self.per_batch[c]["kv_mismatch"] = bad
        out = {}
        for items in (self.per_request, self.per_batch):
            for vals in items.values():
                for k, v in vals.items():
                    out[k] = max(out.get(k, 0.0), v)
        return out

    def _attn_err(self, prompts, queries, precision, program
                  ) -> Dict[int, float]:
        """Per batch, K4's output of every step against the reference's
        attention over the pool the loop fills: layer 0's latent rows of
        the prompt, then a zero row per decoded token (for the control, one
        entry: the reference over a float8 pool)."""
        ref, m, dev = self.reference, self.m, self.device
        rows = torch.stack([ref.layer0_latent(m, self.weights,
                                              torch.as_tensor(p, device=dev))
                            for p in prompts])
        pad = torch.zeros((rows.shape[0], self.tr["decode"]) + rows.shape[2:],
                          device=dev)
        pool = torch.cat([rows, pad], dim=1)
        low = ref.round_fp8(pool)
        scale, dv = ref.softmax_scale(m), m["kv_lora_rank"]
        err = {c: 0.0 for c in range(len(self.calls) if program else 1)}
        for i, q in enumerate(queries):
            qd = torch.as_tensor(q, device=dev)
            n_ctx = self.tr["prefill"] + i
            want = ref.latent_attention(qd, pool, n_ctx, scale, dv)
            if program:
                for c, call in enumerate(self.calls):
                    if i < len(call["attn_out"]):
                        err[c] = max(err[c], ref.max_rel_err(
                            call["attn_out"][i], want))
            else:
                got = ref.latent_attention(qd, low, n_ctx, scale, dv)
                err[0] = max(err[0], ref.max_rel_err(got, want))
        return err

    def _kv_mismatch(self) -> Dict[int, int]:
        """Per batch, the KV counters that differ from the reference's
        accounting at the latent's page bytes (the simulated seconds beyond
        a billionth)."""
        tr, ref = self.tr, self.reference
        page_bytes = ref.latent_page_bytes(self.m, tr["page_size"])
        rd, wr = ref.cxl_payload_gbps(tr["cxl"])
        out = {}
        for c, call in enumerate(self.calls):
            want = ref.kv_accounting(
                tr["requests"], tr["prefill"], len(call["attn_out"]),
                tr["page_size"], tr["hbm_pages"], page_bytes, rd, wr)
            got = call["kv_stats"]
            out[c] = sum(abs(got[k] - v) > 1e-9 * abs(v)
                         if k == "sim_seconds" else got[k] != v
                         for k, v in want.items())
        return out
