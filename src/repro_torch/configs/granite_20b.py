"""Granite-20B code model [arXiv:2405.04324; hf]: llama-arch, MQA (kv=1)."""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="granite_20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, act="gelu",
)
