"""Roofline assembly for one H100: terms from the dry run's traced counts
plus the CXL tier term.

Per (arch x shape) cell, from a :mod:`repro_torch.launch.dryrun` row:

    compute_s = traced FLOPs / 989e12              (bf16 dense peak, H100 SXM)
    memory_s  = matrix-product bytes / 3.35e12     (HBM3)
    cxl_s     = tiering-plan off-HBM traffic / calibrated CXL path

with ``memory_hi_s`` (all operations' bytes over HBM) as the diagnostic
ceiling, plus MODEL_FLOPS (the analytic 6*N*D convention) and the
useful-compute ratio MODEL / traced that flags recomputation and masked
work.  One card has no collectives: ``collective_s`` is 0.  The peaks are
data-sheet values (:mod:`repro_torch.core.spec`), not measurements.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List

from repro_torch.configs import get_config
from repro_torch.core import spec as hw
from repro_torch.memory import tiering
from repro_torch.models.model import ShapeCell

PEAK_FLOPS = hw.H100_BF16_FLOPS
HBM_BW = hw.H100_HBM_GBPS
CHIPS = 1
MESH_TAG = "1xH100"


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (6*N*D convention; excludes remat recompute)
# ---------------------------------------------------------------------------
def _attn_flops_token(cfg, ctx: float) -> float:
    """Forward attention matmul flops per token per ATTENTION layer."""
    if cfg.attn_kind == "mla" and cfg.mla:
        dims = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return 4.0 * cfg.n_heads * dims * ctx
    eff_ctx = min(ctx, cfg.window) if cfg.window else ctx
    return 4.0 * cfg.n_heads * cfg.head_dim * eff_ctx


def model_flops(cfg, cell: ShapeCell) -> float:
    n_act = cfg.n_active_params()
    attn_layers = sum(1 for k in cfg.layer_kinds() if k in ("attn", "moe"))
    rwkv_layers = sum(1 for k in cfg.layer_kinds() if k == "rwkv")
    hd = cfg.rwkv_head_dim
    rwkv_tok = 6.0 * cfg.d_model * hd * rwkv_layers     # WKV state math
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tokens = b * s
        attn = attn_layers * _attn_flops_token(cfg, s / 2.0)
        return tokens * (6.0 * n_act + 3.0 * (attn + rwkv_tok))
    if cell.kind == "prefill":
        tokens = b * s
        attn = attn_layers * _attn_flops_token(cfg, s / 2.0)
        return tokens * (2.0 * n_act + attn + rwkv_tok)
    # decode: one token against ctx = seq_len
    attn = attn_layers * _attn_flops_token(cfg, float(s))
    return b * (2.0 * n_act + attn + rwkv_tok)


# ---------------------------------------------------------------------------
# Per-cell roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float               # matrix products' bytes (headline)
    memory_hi_s: float            # every operation's bytes (diagnostic)
    collective_s: float
    cxl_s: float
    dominant: str
    flops_dev: float              # traced
    traffic_dev: float
    dot_traffic_dev: float
    model_flops_total: float
    useful_ratio: float           # MODEL / traced
    mfu_bound: float              # model compute time / dominant bound
    bytes_per_device: int         # the dry run's peak estimate
    fits: bool
    next_action: str = ""

    def terms(self) -> Dict[str, float]:
        return {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s, "cxl": self.cxl_s}

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def _suggestion(dom: str) -> str:
    if dom == "memory":
        return ("memory-bound: raise arithmetic intensity: fuse the "
                "elementwise passes around the products into a hand-written "
                "kernel on the card, a wider microbatch, or bf16 logits to "
                "cut LM-head traffic")
    if dom == "cxl":
        return ("CXL-bound: deepen prefetch overlap or increase HBM-resident "
                "fraction (tiering plan)")
    return ("compute-bound: good; push the share of the card's bf16 "
            "tensor-core peak with fused kernels")


def cell_of(row: Dict) -> ShapeCell:
    """The (possibly cut) shape cell a dry-run row was traced at."""
    return ShapeCell(row["shape"], row["seq_len"], row["global_batch"],
                     row["kind"])


def config_of(row: Dict):
    """The configuration a dry-run row was traced with (overrides applied)."""
    return dataclasses.replace(get_config(row["arch"]),
                               **row.get("overrides", {}))


def analyze_cell(row: Dict) -> Roofline:
    """The roofline of one ``ok`` dry-run row."""
    cfg, cell = config_of(row), cell_of(row)
    compute_s = row["flops"] / PEAK_FLOPS
    # memory bracketed: `memory_s` counts only the matrix products'
    # operands and outputs (what fused kernels would move), `memory_hi_s`
    # every operation's, as eager PyTorch moves them
    memory_s = row["dot_traffic_bytes"] / HBM_BW
    memory_hi_s = row["traffic_bytes"] / HBM_BW
    if cell.kind == "train":
        plan = tiering.plan_training(cfg, n_devices=CHIPS,
                                     batch=cell.global_batch,
                                     seq=cell.seq_len)
    else:
        plan = tiering.plan_serving(cfg, n_devices=CHIPS,
                                    batch=cell.global_batch,
                                    context=cell.seq_len)
    mf = model_flops(cfg, cell)
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0,
             "cxl": plan.cxl_seconds}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mfu_bound = (mf / CHIPS / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return Roofline(
        arch=row["arch"], shape=row["shape"], mesh=row["mesh"], chips=CHIPS,
        compute_s=compute_s, memory_s=memory_s, memory_hi_s=memory_hi_s,
        collective_s=0.0, cxl_s=plan.cxl_seconds, dominant=dominant,
        flops_dev=row["flops"], traffic_dev=row["traffic_bytes"],
        dot_traffic_dev=row["dot_traffic_bytes"], model_flops_total=mf,
        useful_ratio=mf / max(row["flops"] * CHIPS, 1.0),
        mfu_bound=min(mfu_bound, 1.0),
        bytes_per_device=row["peak_memory_per_device"], fits=row["fits"],
        next_action=_suggestion(dominant))


def analyze_dir(dryrun_dir, mesh_tag: str = MESH_TAG) -> List[Roofline]:
    """Rooflines of every ``ok`` row of a dry-run directory."""
    rows: List[Roofline] = []
    for jf in sorted(pathlib.Path(dryrun_dir).glob(f"*__{mesh_tag}.json")):
        meta = json.loads(jf.read_text())
        if meta["status"] == "ok":
            rows.append(analyze_cell(meta))
    return rows


def to_markdown(rows: List[Roofline]) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | memory_hi_s | "
           "cxl_s | dominant | MODEL/traced | MFU-bound | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.2e} | "
            f"{r.memory_s:.2e} | {r.memory_hi_s:.2e} | {r.cxl_s:.2e} | "
            f"**{r.dominant}** | {r.useful_ratio:.2f} | "
            f"{r.mfu_bound:.1%} | {r.fits} |\n")
    return "".join(out)
