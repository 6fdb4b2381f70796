"""Grok-1 314B [hf:xai-org/grok-1]: 8 experts top-2 MoE."""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="grok_1_314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, num_experts=8, top_k=2, act="gelu", gated_ffn=True,
)
