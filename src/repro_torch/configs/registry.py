"""Architecture registry: one ArchConfig per assigned architecture (port of
``repro.configs.registry``, value for value).

``get_config(name)`` returns the full published config; ``smoke_config``
shrinks it (same family/topology, tiny dims) for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "get_config", "smoke_config", "ARCH_IDS", "SHAPES"]

ARCH_IDS = [
    "qwen2_vl_2b",
    "nemotron_4_340b",
    "granite_20b",
    "deepseek_coder_33b",
    "qwen2_72b",
    "xlstm_1_3b",
    "phi3_5_moe",
    "grok_1_314b",
    "hymba_1_5b",
    "whisper_large_v3",
]

# assigned input-shape set (LM family): name → (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // num_heads
    # MoE
    num_experts: int = 0
    top_k: int = 0
    # variants
    act: str = "silu"
    gated_ffn: bool | None = None   # None → gated iff act == "silu"
    qkv_bias: bool = False
    rope_kind: str = "standard"  # standard | mrope | none
    ssm_state: int = 0
    window: int = 0              # sliding-window attention (0 = full)
    encoder_layers: int = 0      # enc-dec (whisper)
    max_decoder_len: int = 448   # whisper decoder envelope
    subquadratic: bool = False   # eligible for long_500k
    frontend_stub: bool = False  # vlm/audio: embeddings provided externally
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_gated_ffn(self) -> bool:
        return self.act == "silu" if self.gated_ffn is None else self.gated_ffn

    def param_count(self) -> int:
        """Approximate N for MODEL_FLOPS = 6·N·D accounting."""
        d, f, l, v = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        fmul = 3 if self.is_gated_ffn else 2
        if self.family == "moe":
            ffn = fmul * d * f * self.num_experts
        elif self.family == "ssm":
            ffn = 0
            attn = 11 * d * d  # mLSTM (5·d²) + sLSTM (6·d²) per super-layer
        else:
            ffn = fmul * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        layers = l + self.encoder_layers
        return layers * (attn + ffn) + emb

    def active_param_count(self) -> int:
        """N_active for MoE (6·N_active·D accounting)."""
        if self.family != "moe":
            return self.param_count()
        d, f, l, v = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffn = (3 if self.is_gated_ffn else 2) * d * f * self.top_k
        emb = v * d * 2
        return l * (attn + ffn) + emb


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    cfg = get_config(name)
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        window=min(cfg.window, 32) if cfg.window else 0,
        max_decoder_len=32,
    )
