"""Roofline analysis (port of ``repro.launch.roofline``), priced for the
NVIDIA H100 SXM5 80GB HBM3 at 700 W.

Three terms per (arch × shape × mesh), all in SECONDS per step:

  compute    = FLOPs_per_device / 989e12      (H100 SXM5 dense bf16 peak)
  memory     = HBM_bytes_per_device / 3.35e12
  collective = Σ over mesh axes of collective bytes / that axis's link rate:
               "model" over NVLink 4 (450e9 B/s per direction per GPU,
               inside one 8-GPU HGX node), "data" and "pod" over NDR
               InfiniBand (50e9 B/s per GPU, one 400 Gb/s NIC per GPU)

The constants are NVIDIA's datasheet values for the H100 SXM5 at its full
700 W power limit, not measurements; a card set below 700 W runs slower.
The FLOP and byte formulas of :func:`analytic_cell` are the reference's,
term for term (an analytic per-architecture model, as the reference's
``cost_analysis()`` counts a scanned body once); the dry-run's counted
local FLOPs are recorded beside them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import SHAPES, ArchConfig

__all__ = ["HW", "H100", "analytic_cell", "roofline_terms", "format_row"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # bf16 dense, tensor cores, per GPU
    f32_flops: float = 67e12          # f32 outside the tensor cores
    hbm_bw: float = 3.35e12           # B/s per GPU (HBM3)
    hbm_bytes: float = 80 * 2**30     # capacity per GPU
    nvlink_bw: float = 450e9          # B/s per direction per GPU: the "model" axis
    ib_bw: float = 50e9               # B/s per GPU, NDR InfiniBand: "data", "pod"
    chips: int = 256                  # the 256-rank production mesh

    def axis_bw(self, axis: str) -> float:
        return self.nvlink_bw if axis == "model" else self.ib_bw


H100 = HW()


def _n_matmul(cfg: ArchConfig, active: bool) -> float:
    """Params participating in matmuls (embedding GATHER excluded, LM head
    included; for tied embeddings the single table plays both roles)."""
    n = cfg.active_param_count() if active else cfg.param_count()
    from repro_torch.models.transformer import padded_vocab

    emb = padded_vocab(cfg) * cfg.d_model
    if not cfg.tie_embeddings:
        n -= emb  # gather side
    return float(n)


def analytic_cell(cfg: ArchConfig, shape_name: str, *, remat: str = "nothing",
                  lut_serving: bool = False, hw: HW = H100) -> dict:
    """Per-DEVICE analytic flops & HBM bytes for one cell (``hw.chips``
    devices), the reference's formulas."""
    seq, gb, kind = SHAPES[shape_name]
    devs = hw.chips
    hd = cfg.resolved_head_dim
    heads = cfg.num_heads
    L = cfg.num_layers + cfg.encoder_layers
    dtype_b = 2  # bf16

    n_act = _n_matmul(cfg, active=True)
    param_bytes = cfg.param_count() * dtype_b

    if kind in ("train", "prefill"):
        if cfg.encoder_layers:
            tokens = gb * (seq + cfg.max_decoder_len)   # enc frames + dec text
            attn_tokens_sq = gb * (seq**2 + cfg.max_decoder_len**2 / 2
                                   + seq * cfg.max_decoder_len)  # enc + dec + cross
        else:
            tokens = gb * seq
            eff = min(seq, cfg.window) if cfg.window else seq
            attn_tokens_sq = gb * seq * eff / 2          # causal (window-capped)

        matmul_fwd = 2.0 * n_act * tokens
        attn_fwd = 2.0 * heads * hd * attn_tokens_sq * 2  # qk + pv
        if cfg.family == "ssm":
            # mLSTM chunked: intra-chunk (c=256) + state update per chunk
            c = 256
            attn_fwd = gb * seq * heads * (4 * c * hd + 4 * hd * hd) * cfg.num_layers
        if cfg.family == "hybrid":
            attn_fwd += 2.0 * gb * seq * (2 * cfg.d_model) * cfg.ssm_state * 4 * cfg.num_layers

        fwd = matmul_fwd + attn_fwd
        if kind == "train":
            remat_mult = {"nothing": 1.0, "dots": 0.4, "none": 0.0}[remat]
            total = fwd * (3.0 + remat_mult)  # fwd + bwd(2×) + remat refwd
            # HBM: weights (fwd+bwd+remat reads, grad rs) + opt (f32 m,v,p)
            w_traffic = param_bytes * (2 + remat_mult) + cfg.param_count() * 4
            opt_traffic = cfg.param_count() * (4 + 4) * 2          # m,v read+write
            act_traffic = 2 * L * tokens / devs * cfg.d_model * dtype_b * 4
            bytes_dev = (w_traffic + opt_traffic) / devs + act_traffic
            flops_dev = total / devs
            model_flops = 6.0 * n_act * tokens
        else:  # prefill
            flops_dev = fwd / devs
            act_traffic = L * tokens / devs * cfg.d_model * dtype_b * 3
            bytes_dev = param_bytes / devs + act_traffic
            model_flops = 2.0 * n_act * tokens
    else:  # decode: one token for the whole batch
        tokens = gb
        cache_len = min(seq, cfg.window) if cfg.window else seq
        if cfg.encoder_layers:
            cache_len = cfg.max_decoder_len
        matmul = 2.0 * n_act * tokens
        if lut_serving:
            # Pegasus LUT path: matmul flops collapse to comparisons+gathers
            matmul = matmul * 0.0
        if cfg.family == "ssm":
            attn = tokens * heads * (4 * hd * hd) * cfg.num_layers
            cache_bytes = (cfg.num_layers * gb * heads * hd * (hd + 1) * 4) * 2
        else:
            attn = 4.0 * tokens * heads * hd * cache_len * cfg.num_layers
            kv = cfg.num_kv_heads
            cache_bytes = 2 * cfg.num_layers * gb * cache_len * kv * hd * dtype_b
            if cfg.family == "hybrid":
                cache_bytes += cfg.num_layers * gb * 2 * cfg.d_model * cfg.ssm_state * 4 * 2
        flops_dev = (matmul + attn) / devs
        weight_bytes = n_act * (1 if lut_serving else dtype_b)  # int8 LUT option
        bytes_dev = (weight_bytes + cache_bytes) / devs
        model_flops = 2.0 * n_act * tokens

    return dict(
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        model_flops_total=model_flops,
        tokens=tokens,
    )


def roofline_terms(cfg: ArchConfig, shape_name: str, collective_bytes: float, *,
                   collective_by_axis: dict | None = None, remat: str = "nothing",
                   hw: HW = H100, lut_serving: bool = False) -> dict:
    """The three terms. ``collective_by_axis`` (``{axis: {kind: bytes}}``,
    the dry-run's) prices each axis at its link; without it all
    ``collective_bytes`` cross InfiniBand (the slower link)."""
    a = analytic_cell(cfg, shape_name, remat=remat, lut_serving=lut_serving, hw=hw)
    compute_s = a["flops_per_device"] / hw.peak_flops
    memory_s = a["bytes_per_device"] / hw.hbm_bw
    if collective_by_axis:
        coll_s = sum(sum(kinds.values()) / hw.axis_bw(axis)
                     for axis, kinds in collective_by_axis.items())
    else:
        coll_s = collective_bytes / hw.ib_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    total_flops = a["flops_per_device"] * hw.chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": a["model_flops_total"],
        "hlo_flops_analytic": total_flops,
        "useful_ratio": a["model_flops_total"] / max(total_flops, 1.0),
        "bound_step_s": max(terms.values()),
        "roofline_frac": terms[dominant] and (
            min(compute_s / max(terms.values()), 1.0)),
        "tokens": a["tokens"],
    }


def format_row(arch: str, shape: str, r: dict) -> str:
    return (f"| {arch} | {shape} | {r['compute_s']*1e3:.1f} | "
            f"{r['memory_s']*1e3:.1f} | {r['collective_s']*1e3:.1f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']*100:.0f}% |")
