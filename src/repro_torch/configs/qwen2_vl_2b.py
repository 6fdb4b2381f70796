"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf]: M-RoPE, dynamic resolution.

Vision frontend is a STUB per assignment: input_specs provides precomputed
patch embeddings; the M-RoPE sectioned rotary structure is implemented.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    rope_kind="mrope", qkv_bias=True, frontend_stub=True, tie_embeddings=True,
)
