"""Phi-3.5-MoE 42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct]: 16e top-2."""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="phi3_5_moe", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, num_experts=16, top_k=2,
)
