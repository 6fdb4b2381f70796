"""Nemotron-4-340B [arXiv:2402.16819]: GQA kv=8, squared-ReLU FFN."""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="nemotron_4_340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, act="sq_relu",
)
