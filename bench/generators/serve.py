"""General generator of closed-loop serving: one batch of requests after
another through ``launch.serve.run``, the next sent when the last returns.

The traffic file gives the batch (requests, prompt and output lengths), the
KV pool (page size, HBM page budget), the CXL path whose payload rates
price the pool's crossings, and the noise on the norm scales.  The weights
come from ``--seed`` (the reference's :func:`make_params`), drawn on the
device and handed to the program as ``params=``.  ``serve.run`` draws its
prompts and decode queries from ``numpy.random.default_rng(0)`` whatever
the seed; the reference draws the same.

The benchmark reads the logits where the program makes them, by wrapping
``models.transformer.forward_prefill`` and ``decode_step``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from harness.core import Checks
from harness.trace import Profile, ranged

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "window", "rope_theta", "norm_eps",
              "dtype", "tie_embeddings")


def program_config(m: Dict):
    """The program's configuration of `m`: its architecture's, with every
    size of the configuration file put in."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(m["program_arch"]),
                               **{k: m[k] for k in MODEL_KEYS})


def program_params(m: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The benchmark's weights in the program's parameter tree."""
    layers = [{"b0": {"ln1": {"scale": w[f"l{i}.ln1"]},
                      "attn": {"wqkv": w[f"l{i}.wqkv"], "wo": w[f"l{i}.wo"]},
                      "ln2": {"scale": w[f"l{i}.ln2"]},
                      "mlp": {"wiu": w[f"l{i}.wiu"],
                              "wo": w[f"l{i}.wo_mlp"]}}}
              for i in range(m["n_layers"])]
    return {"embed": {"table": w["embed"]},
            "final_norm": {"scale": w["final_norm"]},
            "head": {"w": w["head"]}, "segments": [layers]}


class Run:
    """One run of a serving cell: set-up, window, check."""

    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.kernels import build
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tf

        self.cell, self.seed, self.device = cell, seed, device
        self.m, self.tr = cell.config["model"], cell.traffic
        self.reference = cell.reference()
        self.serve, self.tf = serve, tf
        t0 = time.perf_counter()
        if device.type == "cuda":
            build.build(tuple(self.tr["kernels"]))
        self.build_s = time.perf_counter() - t0
        w = self.m.get("window")
        if w and w < self.tr["prefill"] + self.tr["decode"]:
            # the loop then stashes a rolled window, which the reference's
            # pool does not model
            raise ValueError("the serving cell needs prompt + output "
                             "within the attention window")
        self.cfg = program_config(self.m)
        self.weights = self.reference.make_params(
            self.m, seed, device, self.tr["norm_noise"])
        self.params = program_params(self.m, self.weights)
        # logits where the program makes them, in call order
        self.prefill_logits: List[torch.Tensor] = []
        self.decode_logits: List[torch.Tensor] = []
        self._saved = {"forward_prefill": tf.forward_prefill,
                       "decode_step": tf.decode_step}

        def prefill(*args, **kwargs):
            logits, cache = self._saved["forward_prefill"](*args, **kwargs)
            self.prefill_logits.append(logits)
            return logits, cache

        def decode(*args, **kwargs):
            logits, cache = self._saved["decode_step"](*args, **kwargs)
            self.decode_logits.append(logits)
            return logits, cache

        tf.forward_prefill, tf.decode_step = prefill, decode
        self.calls: List[Dict] = []
        self.call(self.tr["warmup_decode"])   # the cell's kernels, loaded
        self.calls.clear()
        self.prefill_logits.clear()
        self.decode_logits.clear()

    def call(self, decode: int) -> Dict:
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

    def window(self, seconds: float) -> Dict[str, float]:
        """Batches back to back until `seconds` have passed (one at least);
        the last one runs to its end."""
        t0 = time.perf_counter()
        while not self.calls or time.perf_counter() - t0 < seconds:
            self.call(self.tr["decode"])
        n = len(self.calls)
        tokens = n * self.tr["requests"] * self.tr["decode"]
        wall = self.calls[-1]["t1"] - self.calls[0]["t0"]
        steps = n * self.tr["decode"]
        self.notes = {"batches": n, "wall_s": wall,
                      "prefill_s": [c["prefill_s"] for c in self.calls],
                      "decode_s": [c["decode_s"] for c in self.calls]}
        return {"serve_tokens_per_s": tokens / wall,
                "decode_step_ms": sum(c["decode_s"] for c in self.calls)
                / steps * 1e3}

    def traced(self, steps: int) -> Profile:
        """One more batch; `steps` of its decode steps, from the
        traffic's ``profile_from``, under the profiler, with K4 in a
        ``bench.k4`` range."""
        from repro_torch.kernels import ops

        prof = Profile(self.device)
        first = self.tr["profile_from"]
        self.k4_calls: List[Dict] = []
        n_k4 = [0]
        win = []

        def record(args, kwargs):
            q, kp, _, bt, cl = args
            if n_k4[0] == first:
                prof.start()
                win.append(prof.open_window())
            if n_k4[0] == first + steps:
                prof.close_window(win.pop())
                prof.stop()
            if first <= n_k4[0] < first + steps:
                self.k4_calls.append({"q": tuple(q.shape),
                                      "q_bytes": q.element_size(),
                                      "pages": tuple(kp.shape),
                                      "kv_bytes": kp.element_size(),
                                      "blocks": bt.shape[1], "ctx": cl})
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
        return prof

    def counters(self) -> Dict:
        window = [c for c in self.calls if c.get("timed", True)]
        return {"model": self.m, "requests": self.tr["requests"],
                "prefill": self.tr["prefill"], "decode": self.tr["decode"],
                "calls": len(window),
                "prefill_s": [c["prefill_s"] for c in window],
                "decode_s": [c["decode_s"] for c in window],
                "traced_steps": getattr(self, "traced_steps", 0),
                "k4_calls": getattr(self, "k4_calls", [])}

    def release(self) -> None:
        self.tf.forward_prefill = self._saved["forward_prefill"]
        self.tf.decode_step = self._saved["decode_step"]
        del self.params

    @property
    def attempted(self) -> int:
        return len(self.calls) * self.tr["requests"]

    # -- the comparison ------------------------------------------------------
    def _inputs(self):
        tr, m = self.tr, self.m
        return self.reference.serve_inputs(
            tr["requests"], tr["prefill"], tr["decode"], m["vocab_size"],
            m["n_heads"], m["head_dim"], tr["program_rng_seed"])

    def sample(self) -> List:
        """(call, request) pairs to hold against the full forward, drawn
        from the seed among the finished requests (all equally long)."""
        pairs = [(c, r) for c in range(len(self.calls))
                 for r in range(self.tr["requests"])]
        rng = np.random.default_rng(self.seed)
        pick = rng.choice(len(pairs), size=min(self.tr["check_requests"],
                                               len(pairs)), replace=False)
        return [pairs[i] for i in sorted(pick)]

    def served(self, c: int, r: int):
        """(program logits (D + 1, V), served tokens (D + 1,)) of request
        `r` of call `c`: the prefill's pick, then each decode step's."""
        R, D = self.tr["requests"], len(self.calls[c]["attn_out"])
        pre = self.prefill_logits[c * R + r][0, -1]
        steps = [self.decode_logits[c * R * D + i * R + r][0, 0]
                 for i in range(D)]
        logits = torch.stack([pre] + steps)
        toks = [int(torch.argmax(pre))] + list(self.calls[c]["tokens"][r])
        return logits, torch.tensor(toks, device=logits.device)

    def readings(self, precision: str = "f32",
                 program: bool = True) -> Dict[str, float]:
        """The numbers compared, each the worst over what it covers: with
        `program`, the program's outputs against the float32 reference
        (per sampled request and per batch in ``self.per_request`` and
        ``self.per_batch``); else the reference computed in `precision` put
        in the program's place (the control)."""
        ref = self.reference
        m, tr, dev = self.m, self.tr, self.device
        prompts, queries = self._inputs()
        self.per_request = {}
        for c, r in self.sample():
            logits, toks = self.served(c, r)
            seq = torch.cat([torch.as_tensor(prompts[r], device=dev),
                             toks[:-1]])
            pos = range(tr["prefill"] - 1, seq.shape[0])
            full = ref.forward(m, self.weights, seq, pos)
            if not program:
                logits = ref.forward(m, self.weights, seq, pos, precision)
                toks = logits.argmax(dim=-1)
            self.per_request[c, r] = {
                "token_gap": ref.greedy_gap(full, toks),
                "logit_err": ref.max_rel_err(logits, full)}
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
        attention over the pool the loop fills: layer 0's prompt keys as
        keys and as values, then a zero row per decoded token (for the
        control, one entry: the reference over a float8 pool)."""
        ref, m, dev = self.reference, self.m, self.device
        keys = torch.stack([ref.layer0_keys(m, self.weights,
                                            torch.as_tensor(p, device=dev))
                            for p in prompts])
        pad = torch.zeros((keys.shape[0], self.tr["decode"]) + keys.shape[2:],
                          device=dev)
        pool = torch.cat([keys, pad], dim=1)
        low = ref.round_fp8(pool)
        err = {c: 0.0 for c in range(len(self.calls) if program else 1)}
        for i, q in enumerate(queries):
            qd = torch.as_tensor(q, device=dev)
            n_ctx = self.tr["prefill"] + i
            want = ref.paged_attention(qd, pool, pool, n_ctx)
            if program:
                for c, call in enumerate(self.calls):
                    if i < len(call["attn_out"]):
                        err[c] = max(err[c], ref.max_rel_err(
                            call["attn_out"][i], want))
            else:
                got = ref.paged_attention(qd, low, low, n_ctx)
                err[0] = max(err[0], ref.max_rel_err(got, want))
        return err

    def _kv_mismatch(self) -> Dict[int, int]:
        """Per batch, the KV counters that differ from the reference's
        accounting (the simulated seconds beyond a billionth)."""
        tr, m = self.tr, self.m
        item = torch.tensor([], dtype=getattr(torch, m["dtype"])).element_size()
        page_bytes = tr["page_size"] * m["n_kv_heads"] * m["head_dim"] * 2 * item
        rd, wr = self.reference.cxl_payload_gbps(tr["cxl"])
        out = {}
        for c, call in enumerate(self.calls):
            want = self.reference.kv_accounting(
                tr["requests"], tr["prefill"], len(call["attn_out"]),
                tr["page_size"], tr["hbm_pages"], page_bytes, rd, wr)
            got = call["kv_stats"]
            out[c] = sum(abs(got[k] - v) > 1e-9 * abs(v)
                         if k == "sim_seconds" else got[k] != v
                         for k, v in want.items())
        return out

    def check(self, limits: Dict) -> Checks:
        """The readings against their limits; a request fails when its own
        numbers or its batch's are over a limit."""
        checks = Checks()
        for name, v in self.readings().items():
            checks.add(name, v, limits[name])
        failed = {cr for cr, vals in self.per_request.items()
                  if any(v > limits[k] for k, v in vals.items())}
        for c, vals in self.per_batch.items():
            if any(v > limits[k] for k, v in vals.items()):
                failed |= {(c, r) for r in range(self.tr["requests"])}
        self.failed = len(failed)
        return checks
