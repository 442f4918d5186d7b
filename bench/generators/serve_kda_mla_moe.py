"""Generator of closed-loop serving for a model of gated delta-rule (KDA)
layers beside latent-attention (MLA) layers over sparse experts, as one
expert-parallel rank holds it (Kimi-Linear-48B-A3B): the ``serve_mla_moe``
generator's batches through ``launch.serve.run``, with this model's
configuration, parameter tree and comparison.

The configuration file holds the model's ``config.json`` keys (the held
experts under ``num_experts``, the router's width and the first held
expert under ``expert_parallel``); the weights come from ``--seed`` (the
reference's :func:`make_params`).  The routes are recorded and compared as
``serve_mla_moe`` does (``route_mismatch``), and each side's logits are
held against the reference along that side's own routes, so that a flip
on a near tie counts once.  The serving loop's pool holds the first MLA
layer's latent pages, over which K4 runs once a step: ``attn_err`` holds
K4's outputs against the reference's attention over the very bf16 rows K4
read, read back from the pool after the batch, so that it measures K4
alone.  Each sequence's state slot is its first KDA layer's recurrent
state and convolution window, which the decode steps rewrite in place:
``state_err`` holds each slot after its batch against the reference's
float32 state of that layer after the same tokens.  ``kv_mismatch``
counts the pool's counters, summed and per kind, that differ from the
reference's accounting (the latent pages' LRU walk, the state slots'
bytes held, read and written back), and the prompt rows in the pool that
differ from the first MLA layer's own cache.

``counters()`` adds the prefill's and the decode's held assignments of
each batch (for the FLOP count), each traced K4 call's shapes (for the
roofline share) and the program's spans of the traced stretch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from harness.core import BENCH, load_module

mla = load_module(BENCH / "generators" / "serve_mla_moe.py",
                  "bench_serve_kda_mla_moe_")

KEEP = ("tokens", "kv_stats", "kv_kinds", "attn_out", "prefill_s",
        "decode_s")


def program_config(m: Dict):
    """The program's configuration of `m`: its architecture's, with every
    size, both mixers, the gate and the held share of the configuration
    file put in."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import KDAConfig, MLAConfig, MoEConfig

    la, ep = m["linear_attn_config"], m["expert_parallel"]
    layers = m["num_hidden_layers"]
    if m["q_lora_rank"] is not None or not m["mla_use_nope"] \
            or m["rope_scaling"] is not None:
        raise ValueError("the MLA layers must project the query directly, "
                         "with no rotary")
    fe = m["moe_intermediate_size"]
    return dataclasses.replace(
        get_config(m["program_arch"]),
        n_layers=layers, d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"],
        head_dim=m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
        vocab_size=m["vocab_size"], norm_eps=m["rms_norm_eps"],
        dtype=m["dtype"], tie_embeddings=m["tie_word_embeddings"],
        rope="nope",
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=m["kv_lora_rank"],
                      qk_nope_head_dim=m["qk_nope_head_dim"],
                      qk_rope_head_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"]),
        kda=KDAConfig(layers=tuple(i for i in range(layers)
                                   if i + 1 in la["kda_layers"]),
                      n_heads=la["num_heads"], head_dim=la["head_dim"],
                      conv=la["short_conv_kernel_size"],
                      chunk=m["kda_chunk"]),
        moe=MoEConfig(
            n_experts=ep["router_experts"],
            top_k=m["num_experts_per_token"],
            n_shared=m["num_shared_experts"], expert_d_ff=fe,
            shared_d_ff=fe, first_dense=m["first_k_dense_replace"],
            dense_d_ff=m["intermediate_size"], scoring="sigmoid",
            n_group=m["num_expert_group"], topk_group=m["topk_group"],
            routed_scale=float(m["routed_scaling_factor"]), score_bias=True,
            held=(ep["first_held_expert"], m["num_experts"])))


def program_params(m: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The benchmark's weights in the program's parameter tree."""
    def mixer(i):
        if i + 1 in m["linear_attn_config"]["kda_layers"]:
            names = ("wqkv", "conv", "wf_a", "wf_b", "wb", "wg_a", "wg_b",
                     "wo", "A_log", "dt_bias")
            return {"kda": dict({n: w[f"l{i}.{n}"] for n in names},
                                o_norm={"scale": w[f"l{i}.o_norm"]})}
        return {"attn": {"wq": w[f"l{i}.wq"], "wkv_a": w[f"l{i}.wkv_a"],
                         "kv_norm": {"scale": w[f"l{i}.kv_norm"]},
                         "wkv_b": w[f"l{i}.wkv_b"], "wo": w[f"l{i}.wo"]}}

    def block(i, ffn):
        return {"b0": {"ln1": {"scale": w[f"l{i}.ln1"]}, **mixer(i),
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


mla.base.program_config = program_config
mla.base.program_params = program_params


class Run(mla.Run):
    """One run of the cell: set-up, window, check."""

    def __init__(self, cell, seed: int, device: torch.device):
        # a program without the KDA layers fails here, at once
        program_config(cell.config)
        self._accounting: Dict[int, Dict] = {}
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
        keep.update(self._pooled(out, decode), t0=t0, t1=t1)
        self.calls.append(keep)
        return keep

    def _pooled(self, out: Dict, decode: int) -> Dict:
        """Copied from a call's pool and caches before they go: each
        sequence's latent rows in the pool (the prompt's, then a zero row
        a decoded token), the prompt rows that differ from the first MLA
        layer's own cache, and each sequence's first KDA layer's cache
        after the batch (its state slot)."""
        kv, caches = out["kv"], out["caches"]
        mla_layer, kda_layer = self.reference.pool_layers(self.m)
        p = self.tr["prefill"]
        rows, states, differ = [], [], 0
        for r in range(self.tr["requests"]):
            got = kv.k_pool[0][kv.block_tables[r]].flatten(0, 1)
            rows.append(got[:p + decode])
            own = self.tf.layer_entry(caches[r], self.cfg, mla_layer)
            own = torch.cat([own["ckv"][0, :p], own["krope"][0, :p]], -1)
            differ += int((got[:p, 0] != own).any(-1).sum())
            states.append({n: x[0].clone() for n, x in self.tf.layer_entry(
                caches[r], self.cfg, kda_layer).items()})
        return {"rows": torch.stack(rows), "rows_differ": differ,
                "states": states}

    def counters(self) -> Dict:
        out = super().counters()
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
    def readings(self, precision: str = "f32",
                 program: bool = True) -> Dict[str, float]:
        """The numbers compared, as ``serve_mla_moe``'s, but each side's
        logits held against the float32 reference along that side's own
        routes (the program's recorded ones, or for the control those of
        the reference in `precision`), so that a route flipped on a near
        tie shows in ``route_mismatch`` (each side's routes against the
        reference's own) and not again in the logits; and ``state_err``
        per batch: each sequence's state slot after the batch (for the
        control, the reference's state in `precision`) against the
        reference's float32 state after the same tokens."""
        ref = self.reference
        m, tr, dev = self.m, self.tr, self.device
        prompts, queries = self._inputs()
        self.per_request = {}
        for c, r in self.sample():
            logits, toks = self.served(c, r)
            seq = torch.cat([torch.as_tensor(prompts[r], device=dev),
                             toks[:-1]])
            pos = range(tr["prefill"] - 1, seq.shape[0])
            own = []
            ref.forward(m, self.weights, seq, pos, routes=own)
            if program:
                side = self.program_routes(c, r)
            else:
                side = []
                logits = ref.forward(m, self.weights, seq, pos, precision,
                                     routes=side)
                toks = logits.argmax(dim=-1)
            full = ref.forward(m, self.weights, seq, pos, force=side)
            self.per_request[c, r] = {
                "token_gap": ref.greedy_gap(full, toks),
                "logit_err": ref.max_rel_err(logits, full),
                "route_mismatch": sum(ref.held_mismatch(g, w, m)
                                      for g, w in zip(side, own))}
        self.per_batch = {c: {"attn_err": a} for c, a in self._attn_err(
            queries, program).items()}
        if program:
            for c, bad in self._kv_mismatch().items():
                self.per_batch[c]["kv_mismatch"] = bad
        for c, err in self._state_err(precision, program).items():
            self.per_batch[c]["state_err"] = err
        out = {}
        for items in (self.per_request, self.per_batch):
            for vals in items.values():
                for k, v in vals.items():
                    out[k] = max(out.get(k, 0.0), v)
        return out

    def _state_err(self, precision, program) -> Dict[int, float]:
        ref, dev, tr = self.reference, self.device, self.tr
        prompts, _ = self._inputs()
        after_prompt = [ref.layer_state(self.m, self.weights,
                                        torch.as_tensor(p, device=dev))
                        for p in prompts]
        err = {}
        for c, call in enumerate(self.calls if program else self.calls[:1]):
            worst = 0.0
            for r, start in enumerate(after_prompt):
                _, toks = self.served(c, r)
                fed = toks[:-1]
                want = ref.layer_state(self.m, self.weights, fed,
                                       state=start)
                if program:
                    got = call["states"][r]
                else:
                    got = ref.layer_state(
                        self.m, self.weights, fed, precision,
                        ref.layer_state(self.m, self.weights,
                                        torch.as_tensor(prompts[r],
                                                        device=dev),
                                        precision))
                worst = max(worst, *(ref.max_rel_err(got[n], want[n])
                                     for n in ("S", "conv")))
            err[c] = worst
        return err

    def _attn_err(self, queries, program) -> Dict[int, float]:
        """Per batch, K4's output of every step against the reference's
        attention over the rows K4 read: the pool's bf16 latent rows of
        the batch, the prompt's then a zero row a decoded token (for the
        control, one entry: the reference over the first batch's rows
        rounded to float8)."""
        ref, m, dev = self.reference, self.m, self.device
        scale, dv = ref.softmax_scale(m), m["kv_lora_rank"]
        err = {}
        for c, call in enumerate(self.calls if program else self.calls[:1]):
            pool = call["rows"].float()
            low = None if program else ref.round_fp8(pool)
            err[c] = 0.0
            for i, q in enumerate(queries[:len(call["attn_out"])]):
                qd = torch.as_tensor(q, device=dev)
                n_ctx = self.tr["prefill"] + i
                want = ref.latent_attention(qd, pool, n_ctx, scale, dv)
                got = (call["attn_out"][i] if program else
                       ref.latent_attention(qd, low, n_ctx, scale, dv))
                err[c] = max(err[c], ref.max_rel_err(got, want))
            del pool, low
        return err

    def _kv_mismatch(self) -> Dict[int, int]:
        """Per batch, the pool's counters, summed and per kind (with the
        latent kind's live pages), that differ from the reference's
        accounting (the simulated seconds beyond a billionth): the latent
        pages' walk at the latent's page bytes, the state slots' bytes;
        and the prompt rows in the pool unlike the layer's cache."""
        tr, m, ref = self.tr, self.m, self.reference
        rd, wr = ref.cxl_payload_gbps(tr["cxl"])

        def differ(got, want):
            return sum(abs(got[k] - v) > 1e-9 * abs(v)
                       if k == "sim_seconds" else got[k] != v
                       for k, v in want.items())
        out = {}
        for c, call in enumerate(self.calls):
            d = len(call["attn_out"])
            if d not in self._accounting:
                self._accounting[d] = ref.kv_accounting(
                    tr["requests"], tr["prefill"], d, tr["page_size"],
                    tr["hbm_pages"],
                    [{"page_bytes": ref.latent_page_bytes(
                        m, tr["page_size"]), "ring": None}], rd, wr)
            want = self._accounting[d]
            state = ref.state_accounting(m, tr["requests"], d)
            got = call["kv_kinds"]
            out[c] = call["rows_differ"] + differ(
                call["kv_stats"], want["total"]) + sum(
                differ(got[name], w) if name in got else len(w)
                for name, w in (("latent", want["kinds"][0]),
                                ("state", state)))
        return out
