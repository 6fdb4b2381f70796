"""Hymba-1.5B [arXiv:2411.13676; hf]: parallel attn+mamba heads per layer,
sliding-window attention (full attention in a few layers in the original;
we use SWA uniformly + global SSM state → sub-quadratic, runs long_500k)."""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="hymba_1_5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, ssm_state=16, window=1024,
    head_dim=64, subquadratic=True,
)
